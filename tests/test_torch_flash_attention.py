"""Kernel K3's modules (flash attention), port vs reference, on the CPU.

The port's plain versions (the tensors lie on the CPU, so the kernel
wrapper takes ``flash_torch``) against the reference's Pallas kernel in
interpret mode, ``flash_jnp``, ``mha_ref`` and ``decode_ref``.  Inputs are
drawn with numpy from a seed and handed to both packages.

Tolerances:
* float32: atol = rtol = 1e-5 — the same float32 algorithm, summed in
  another order (measured differences ~1e-6 on unit-normal inputs);
* bfloat16 through the float32 flash paths: one bf16 rounding step of the
  output, rtol = 2**-7, atol = 1e-2 (both round the same float32 value,
  which may straddle a rounding boundary);
* bfloat16 ``mha_ref``: scores and softmax round to bf16 after each op in
  both packages, but not at the same places: the repo's bf16 tolerance
  atol = 0.06, rtol = 0.05 (``tests/test_arch_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as r_flash_attention,
)
from repro.kernels.flash_attention.ref import decode_ref as r_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref  # noqa: E402
from repro.models.attention import attention as r_attention  # noqa: E402
from repro.models.attention import flash_jnp  # noqa: E402

from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref  # noqa: E402
from repro_torch.models.attention import attention, flash_torch  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_FLASH = dict(rtol=2**-7, atol=1e-2)
BF16_NAIVE = dict(rtol=0.05, atol=0.06)
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(b, hq, hkv, s, d, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    tdt, jdt = DT[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,bq,bk",
    [(1, 4, 2, 256, 64, 128, 128), (2, 2, 1, 128, 128, 64, 64),
     (1, 8, 8, 128, 32, 64, 64)],
)
def test_flash_attention_matches_pallas_interpret(b, hq, hkv, s, d, bq, bk):
    (q, k, v), (jq, jk, jv) = _qkv(b, hq, hkv, s, d, seed=s + d)
    ref = r_flash_attention(jq, jk, jv, causal=True, bq=bq, bk=bk, interpret=True)
    got = flash_attention(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
def test_flash_torch_matches_flash_jnp(dtype, causal, window):
    (q, k, v), (jq, jk, jv) = _qkv(2, 4, 2, 256, 32, seed=7, dtype=dtype)
    ref = flash_jnp(jq, jk, jv, causal=causal, q_chunk=64, kv_chunk=64,
                    local_window=window)
    got = flash_torch(q, k, v, causal=causal, q_chunk=64, kv_chunk=64,
                      local_window=window)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(F32 if dtype == "float32" else BF16_FLASH))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_torch_rounded_p_matches_pallas_interpret_bf16(d):
    """``p_dtype=bfloat16`` is the kernels' arithmetic (p rounded to v's
    dtype before PV, the row sums unrounded): in bf16 it matches the
    reference's Pallas kernel, which rounds p the same way, within one bf16
    step of the output (``BF16_FLASH``) on the kernel's chunks, and in all
    but 1e-3 of the outputs bit for bit."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, 256, d, seed=d + 5, dtype="bfloat16")
    ref = r_flash_attention(jq, jk, jv, causal=True, bq=128, bk=128, interpret=True)
    got = flash_torch(q, k, v, causal=True, q_chunk=128, kv_chunk=128,
                      p_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), **BF16_FLASH)
    # the same bits but for a few outputs that a float32 reordering tips
    # over a bf16 boundary; the default, p kept in float32, differs in
    # over a tenth
    assert (_np(got) != _np(ref)).mean() < 1e-3
    plain = flash_torch(q, k, v, causal=True, q_chunk=128, kv_chunk=128)
    assert (_np(plain) != _np(ref)).mean() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 17])
def test_mha_ref_matches_reference(dtype, window):
    (q, k, v), (jq, jk, jv) = _qkv(2, 6, 3, 96, 16, seed=3, dtype=dtype)
    ref = r_mha_ref(jq, jk, jv, causal=True, local_window=window)
    got = mha_ref(q, k, v, causal=True, local_window=window)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(F32 if dtype == "float32" else BF16_NAIVE))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_ref_matches_reference(dtype, window, per_row):
    rng = np.random.default_rng(11)
    b, hq, hkv, s, d = 3, 6, 3, 40, 16
    qn = rng.normal(size=(b, hq, d)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, hkv, s, d)).astype(np.float32) for _ in range(2))
    length = np.array([9, 40, 23], np.int32) if per_row else 23
    tdt, jdt = DT[dtype]
    ref = r_decode_ref(*(jnp.asarray(a, jdt) for a in (qn, kn, vn)),
                       jnp.asarray(length), window=window)
    got = decode_ref(*(torch.from_numpy(a).to(tdt) for a in (qn, kn, vn)),
                     torch.as_tensor(length), window=window)
    assert got.dtype == tdt and got.shape == (b, hq, d)
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(F32 if dtype == "float32" else BF16_FLASH))


@pytest.mark.parametrize("s", [1280, 1, 77, 513])
@pytest.mark.parametrize("window", [None, 300])
def test_flash_torch_ragged_length_matches_mha_ref(s, window):
    """Lengths the reference's flash_jnp cannot reshape (R3): the port's
    chunked version slices the ragged tail and equals its own oracle."""
    (q, k, v), _ = _qkv(1, 4, 2, s, 32, seed=s)
    got = flash_torch(q, k, v, local_window=window)
    np.testing.assert_allclose(got.numpy(), mha_ref(q, k, v, local_window=window).numpy(),
                               **F32)


def test_dispatch_on_cpu_mirrors_the_reference():
    """backend=None off the card: flash_torch for S > 1024, mha_ref else;
    equal to the reference's auto dispatch on the CPU (which picks
    flash_jnp / mha_ref the same way)."""
    for s in (256, 1536):
        (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, s, 16, seed=s)
        got = attention(q, k, v)
        want = flash_torch(q, k, v) if s > 1024 else mha_ref(q, k, v)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), _np(r_attention(jq, jk, jv)), **F32)
    assert torch.equal(attention(q, k, v, backend="naive"), mha_ref(q, k, v))
    assert torch.equal(attention(q, k, v, backend="cuda"), flash_torch(q, k, v))
    with pytest.raises(NotImplementedError):
        attention(q, k, v, backend="cuda", local_window=8)
    with pytest.raises(ValueError):
        attention(q, k, v, backend="pallas")


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take():
    (q, k, v), _ = _qkv(1, 4, 2, 64, 16, seed=0)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :32].contiguous(), v)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_route_table(dtype, d, want):
    """Which kernel a CUDA call launches: bf16 with D 64 or 128 takes the
    tensor-core kernel, everything else the CUDA-core one."""
    from repro_torch.kernels.flash_attention.flash_attention import route

    assert route(dtype, d) == want


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 8, ValueError),
    (torch.bfloat16, 256, ValueError),
])
def test_route_rejects_what_neither_kernel_takes(dtype, d, exc):
    from repro_torch.kernels.flash_attention.flash_attention import route

    with pytest.raises(exc):
        route(dtype, d)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.float32, 64), (torch.bfloat16, 16)])
def test_cpu_tensors_reach_no_kernel(monkeypatch, dtype, d):
    """A CPU call takes the plain version: neither library is loaded and
    no route's count moves."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod

    def no_lib(*_a, **_k):
        raise AssertionError("a kernel library was loaded for CPU tensors")

    monkeypatch.setattr(fa_mod, "_lib", no_lib)
    (q, k, v), _ = _qkv(1, 4, 2, 70, d, seed=d, dtype=str(dtype).split(".")[1])
    before = (fa_mod.flash_attention.launches, dict(fa_mod.flash_attention.launches_by_route))
    got = fa_mod.flash_attention(q, k, v)
    assert torch.equal(got, flash_torch(q, k, v))
    assert (fa_mod.flash_attention.launches,
            fa_mod.flash_attention.launches_by_route) == before


def test_ptxas_report_reads_registers_and_spills(monkeypatch, tmp_path):
    """chip_smoke's spill check on the tensor-core route reads the build
    log through ``build.ptxas_report``: each function's registers, stack
    and spill bytes, and ptxas's count of ignored setmaxnreg."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.library_path("flash_attention_sm90").with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z3fooILi64EEv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3fooILi128EEv' for 'sm_90a'\n"
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    rep = build.ptxas_report("flash_attention_sm90")
    assert rep == {
        "functions": {
            "_Z3fooILi64EEv": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                               "registers": 168},
            "_Z3fooILi128EEv": {"stack": 16, "spill_stores": 12, "spill_loads": 8,
                                "registers": 168}},
        "setmaxnreg_ignored": 1}
