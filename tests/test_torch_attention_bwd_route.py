"""K3's backward route table, on the CPU.

* ``bwd_route`` over every (dtype, head size): bf16 at D 64 and 128 takes
  the tensor-core kernel (``sm90``), everything else the CUDA-core kernel
  (``simt``); what no kernel takes raises.
* The training configs of qwen3-0.6b and qwen2-moe-a2.7b compute attention
  in a (dtype, head size) that takes ``sm90``.
* ``flash_attention_bwd`` on CPU tensors (its plain version: autograd
  through ``flash_torch``) against ``jax.grad`` of the reference's
  ``mha_ref`` at the shapes the sm90 route takes on the card, cut small:
  float32 each element within 1e-4 (the same math in another order); bf16
  inputs a relative L2 error of at most 2e-2 a tensor (the port rounds its
  output to bf16, the reference's gradient is of the unrounded float32
  attention on the same bf16 values).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as K3  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", K3.HEAD_DIMS)
def test_bwd_route_table(dtype, d):
    want = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert K3.bwd_route(dtype, d) == want
    # the backward routes as the forward does
    assert K3.bwd_route(dtype, d) == K3.route(dtype, d)


@pytest.mark.parametrize("dtype,d,exc", [(torch.float16, 64, TypeError),
                                         (torch.float64, 128, TypeError),
                                         (torch.bfloat16, 96, ValueError),
                                         (torch.bfloat16, 256, ValueError),
                                         (torch.float32, 8, ValueError)])
def test_bwd_route_refuses_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        K3.bwd_route(dtype, d)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_training_configs_take_the_tensor_core_backward(arch):
    cfg = get_arch(arch).model_cfg
    assert K3.bwd_route(cfg.cdtype, cfg.head_dim) == "sm90"


def test_bwd_counts_start_by_route():
    assert set(K3.flash_attention_bwd.launches_by_route) == {"sm90", "simt"}


def _ref_grads(q, k, v, do, causal):
    def loss(q, k, v):
        return jnp.sum(r_mha_ref(q, k, v, causal=causal) * do)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# (B, Hq, Hkv, S, D, causal): qwen3's grouping (Hq / Hkv = 2) at D = 64 and
# qwen2-moe's (Hq = Hkv) at D = 128, S ragged around the 64-row tiles
SM90_SHAPES = [(1, 4, 2, 129, 64, True), (2, 2, 2, 65, 128, True),
               (1, 8, 1, 100, 64, True), (1, 4, 2, 77, 128, False)]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", SM90_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_reference_at_sm90_shapes(b, hq, hkv, s, d, causal, dtype):
    rng = np.random.default_rng(s + d + hq)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                   for h in (hq, hkv, hkv, hq))
    qt, kt, vt, dot = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    # the reference on the values the port sees, in float32
    want = _ref_grads(*(t.float().numpy() for t in (qt, kt, vt, dot)), causal)
    o = K3.flash_attention(qt, kt, vt, causal=causal)
    before = (K3.flash_attention_bwd.launches, dict(K3.flash_attention_bwd.launches_by_route))
    got = K3.flash_attention_bwd(qt, kt, vt, o, dot, causal=causal)
    # the CPU takes the plain version: no kernel launched, nothing counted
    assert (K3.flash_attention_bwd.launches,
            K3.flash_attention_bwd.launches_by_route) == before
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == dtype and tuple(g.shape) == w.shape, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
        else:
            assert _rel_l2(g.float().numpy(), w) <= 2e-2, (name, _rel_l2(g.float().numpy(), w))
