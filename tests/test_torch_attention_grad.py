"""Gradients through attention and the dense LM's loss, port vs reference,
on the CPU.

* K3's plain backward (``flash_attention_bwd`` on CPU tensors: autograd
  through ``flash_torch``), and ``FlashAttentionFn`` on CPU tensors,
  against ``jax.grad`` of the reference's ``mha_ref`` and ``flash_jnp``:
  float32, each element within 1e-4 (the same math in another order).
* ``transformer.loss_fn`` at qwen3-0.6b's SMOKE config against
  ``jax.value_and_grad`` of the reference's, the reference's float32
  params carried across with ``convert.lm_train_params_from_arrays`` and
  the gradients brought back stacked with ``convert.lm_tree_to_arrays``:
  with ``compute_dtype="float32"`` the loss within rtol 1e-5 and each leaf
  within atol 1e-5 + rtol 1e-4; in bf16 (as configured) each leaf's
  relative L2 error at most 2e-2 (the packages round bf16 at different
  places).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.qwen3_0p6b import SMOKE as R_SMOKE  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.attention import flash_jnp  # noqa: E402

from repro_torch.configs.qwen3_0p6b import SMOKE  # noqa: E402
from repro_torch.convert import lm_train_params_from_arrays, lm_tree_to_arrays  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as K3  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import attention  # noqa: E402


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]


def _ref_grads(fn, q, k, v, do):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * do)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 4, 2, 64, 16), (1, 4, 4, 100, 32),
                                          (1, 2, 1, 37, 64), (1, 6, 2, 129, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_k3_plain_backward_matches_mha_ref(b, hq, hkv, s, d, causal):
    q, k, v = _qkv(b, hq, hkv, s, d, seed=s + d)
    do = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    want = _ref_grads(lambda q, k, v: r_mha_ref(q, k, v, causal=causal), q, k, v, do)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o = K3.flash_attention(qt, kt, vt, causal=causal)
    got = K3.flash_attention_bwd(qt, kt, vt, o, dot, causal=causal)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_k3_plain_backward_matches_flash_jnp():
    """At S = 1024 in chunks of 256 the reference's chunked path (what it
    trains through off the TPU) against the port's plain backward."""
    q, k, v = _qkv(1, 4, 2, 1024, 64, seed=5)
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    want = _ref_grads(lambda q, k, v: flash_jnp(q, k, v, q_chunk=256, kv_chunk=256),
                      q, k, v, do)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    got = K3.flash_attention_bwd(qt, kt, vt, K3.flash_attention(qt, kt, vt), dot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_flash_attention_fn_on_cpu_is_the_plain_pair():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(2, 4, 2, 50, 32, seed=3))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    o = K3.flash_attention_train(q, k, v)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        assert torch.equal(o, K3.flash_attention_plain(q, k, v))
    want = K3.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_attention_on_cpu_trains_through_the_plain_path():
    """On the CPU ``attention`` takes the plain versions (autograd through
    them), whatever grad mode says; gradients flow into q, k and v."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 4, 2, 40, 16, seed=8))
    out = attention(q, k, v)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(bool(g.abs().sum() > 0) for g in grads)


def test_untracked_guard_raises_only_when_autograd_records():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        build.check_untracked("k", x)
    with torch.no_grad():
        build.check_untracked("k", x)
    build.check_untracked("k", x.detach(), torch.ones(2, dtype=torch.int32))


# ------------------------- the dense LM's loss -------------------------- #
def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(b, s, vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _grad_pair(dtype, b, s, seed, remat=False):
    """(reference loss, reference grads, port loss, port grads), both as
    numpy trees in the reference's stacked layout."""
    rcfg = dataclasses.replace(R_SMOKE, compute_dtype=dtype)
    pcfg = dataclasses.replace(SMOKE, compute_dtype=dtype, remat=remat)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    batch = _batch(b, s, rcfg.vocab, seed)
    rl, rg = jax.value_and_grad(lambda p: RT.loss_fn(p, jax.tree.map(jnp.asarray, batch), rcfg))(
        rparams)
    pparams = lm_train_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                          torch_device="cpu")
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(
        {k: v for k, v in pparams.items() if k != "layers"}))
    from repro_torch.train.trainer import value_and_grad

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pl, pg = value_and_grad(lambda p, bt: T.loss_fn(p, bt, pcfg), pparams, tb)
    return (float(rl), jax.tree.map(np.asarray, rg), float(pl), lm_tree_to_arrays(pg))


def _leaves_by_key(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("b,s", [(2, 24), (1, 40)])
def test_transformer_loss_grads_float32_match_reference(b, s):
    rl, rg, pl, pg = _grad_pair("float32", b, s, seed=s)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    want, got = _leaves_by_key(rg), _leaves_by_key(pg)
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-4, err_msg=key)
        assert np.abs(got[key]).max() > 0, key  # every leaf gets a gradient


def test_transformer_loss_grads_bf16_match_reference():
    rl, rg, pl, pg = _grad_pair("bfloat16", 2, 24, seed=3)
    np.testing.assert_allclose(pl, rl, rtol=1e-2)
    want, got = _leaves_by_key(rg), _leaves_by_key(pg)
    assert want.keys() == got.keys()
    for key in want:
        assert _rel_l2(got[key], want[key]) <= 2e-2, (key, _rel_l2(got[key], want[key]))


def test_remat_gives_the_same_gradients():
    """Per-layer checkpointing recomputes each layer in the backward: the
    loss and every gradient bitwise those without it."""
    _, _, pl0, pg0 = _grad_pair("float32", 2, 24, seed=1, remat=False)
    _, _, pl1, pg1 = _grad_pair("float32", 2, 24, seed=1, remat=True)
    assert pl0 == pl1
    a, b = _leaves_by_key(pg0), _leaves_by_key(pg1)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_serving_forward_bits_unchanged_by_the_cast_at_use():
    """Serving params already hold the compute dtype, so the casts at use
    are no-ops: ``forward`` on ``init`` params equals the same forward on
    params whose weights were cast once more (bitwise)."""
    cfg = SMOKE
    params = T.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_batch(2, 16, cfg.vocab, 0)["tokens"])
    again = {**params, "layers": [{k: v.clone() for k, v in lp.items()} for lp in params["layers"]]}
    with torch.no_grad():
        assert torch.equal(T.forward(params, toks, cfg), T.forward(again, toks, cfg))
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    master = T.init_master(torch.Generator().manual_seed(0), cfg)
    assert master["layers"][0]["wq"].dtype == torch.float32
    assert torch.equal(master["layers"][0]["wq"].to(torch.bfloat16), params["layers"][0]["wq"])
