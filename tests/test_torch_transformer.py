"""The dense-LM serving path (qwen3-0.6b SMOKE), port vs reference, on the CPU.

The reference's ``init`` params are carried across with
``convert.transformer_params_from_arrays``; prompts are drawn with numpy
from a seed.  Prompt length 12 takes the materializing attention in both
packages, 1536 the chunked flash path (``flash_jnp`` / ``flash_torch``).

Tolerances:
* ``compute_dtype="float32"``: logits within atol = rtol = 1e-4 (the same
  float32 arithmetic in another summation order) and greedy tokens equal;
* as configured (bf16): logits within atol = 0.06, rtol = 0.05, the repo's
  own bf16 tolerance (``tests/test_arch_smoke.py``): the two frameworks
  round bf16 at different places.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.qwen3_0p6b import SMOKE as R_SMOKE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs.qwen3_0p6b import SMOKE  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_arrays  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, reference cfg, reference params, port cfg, port params)."""
    dtype = request.param
    rcfg = dataclasses.replace(R_SMOKE, compute_dtype=dtype)
    pcfg = dataclasses.replace(SMOKE, compute_dtype=dtype)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree.map(np.asarray, rparams)
    pparams = transformer_params_from_arrays(tree, pcfg, torch_device="cpu")
    return dtype, rcfg, rparams, pcfg, pparams


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_config_and_param_count_match_reference():
    arch = get_arch("qwen3-0.6b")
    from repro.configs.qwen3_0p6b import CONFIG as R_CONFIG

    assert arch.model_cfg.n_params() == R_CONFIG.n_params()
    assert arch.model_cfg.head_dim == R_CONFIG.head_dim == 64
    g = torch.Generator().manual_seed(0)
    params = T.init(g, SMOKE)
    n = sum(t.numel() for lp in params["layers"] for t in lp.values())
    n += params["embed"].numel() + params["ln_f"].numel()
    qk = 2 * SMOKE.head_dim * SMOKE.n_layers  # q/k norms, not in n_params
    assert n - qk == SMOKE.n_params()
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    assert params["layers"][0]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("s", [12, 1536])
def test_prefill_matches_reference(pair, s):
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = _tokens(2, s, pcfg.vocab, seed=s)
    rkv, rlogits = RT.prefill(rparams, jnp.asarray(toks), rcfg)
    kv, logits = T.prefill(pparams, torch.from_numpy(toks), pcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, pcfg.vocab)
    _close(logits.numpy(), rlogits, dtype)
    for name in ("k", "v"):
        assert kv[name].shape == rkv[name].shape
        _close(kv[name].float().numpy(), rkv[name].astype(jnp.float32), dtype)


def test_forward_matches_reference(pair):
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = _tokens(2, 10, pcfg.vocab, seed=1)
    _close(T.forward(pparams, torch.from_numpy(toks), pcfg).numpy(),
           RT.forward(rparams, jnp.asarray(toks), rcfg), dtype)


@pytest.mark.parametrize("s", [12, 1536])
def test_decode_step_matches_reference(pair, s):
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = _tokens(2, s, pcfg.vocab, seed=s + 1)
    rkv, rlogits = RT.prefill(rparams, jnp.asarray(toks), rcfg)
    rkv = {k: jnp.pad(v, ((0, 0),) * 3 + ((0, 4), (0, 0))) for k, v in rkv.items()}
    nxt = np.asarray(jnp.argmax(rlogits, -1)).astype(np.int32)
    rlog2, rkv2 = RT.decode_step(rparams, jnp.asarray(nxt), rkv, s, rcfg)

    kv, _ = T.prefill(pparams, torch.from_numpy(toks), pcfg)
    kv = {k: torch.nn.functional.pad(v, (0, 0, 0, 4)) for k, v in kv.items()}
    log2, kv2 = T.decode_step(pparams, torch.from_numpy(nxt), kv, s, pcfg)
    _close(log2.numpy(), rlog2, dtype)
    for name in ("k", "v"):
        _close(kv2[name].float().numpy(), rkv2[name].astype(jnp.float32), dtype)


def test_decode_matches_full_forward(pair):
    """The port's own consistency: a decode step after prefill gives the
    full forward's last logits (the reference's serve smoke check)."""
    dtype, _, _, pcfg, pparams = pair
    toks = torch.from_numpy(_tokens(2, 8, pcfg.vocab, seed=2))
    kv, logits = T.prefill(pparams, toks, pcfg)
    kv = {k: torch.nn.functional.pad(v, (0, 0, 0, 4)) for k, v in kv.items()}
    nxt = logits.argmax(-1)
    logits2, _ = T.decode_step(pparams, nxt, kv, 8, pcfg)
    full = T.forward(pparams, torch.cat([toks, nxt[:, None].int()], 1), pcfg)
    np.testing.assert_allclose(logits2.numpy(), full[:, -1].numpy(),
                               atol=0.06, rtol=0.05)


@pytest.mark.parametrize("s", [12, 1536])
def test_generate_matches_reference_float32(s):
    cfg = dataclasses.replace(SMOKE, compute_dtype="float32")
    rcfg = dataclasses.replace(R_SMOKE, compute_dtype="float32")
    rparams = RT.init(jax.random.PRNGKey(1), rcfg)
    pparams = transformer_params_from_arrays(jax.tree.map(np.asarray, rparams),
                                             cfg, torch_device="cpu")
    prompts = _tokens(2, s, cfg.vocab, seed=s + 2)
    lens = (s, s - 3)  # ragged prompts: right-padded with token 0 in both
    mk = [(i, prompts[i, :n], 5 - i) for i, n in enumerate(lens)]
    want = RServeEngine(rparams, rcfg, RT, max_seq=s + 8, slots=2).generate(
        [RRequest(rid=i, prompt=p, max_new=m) for i, p, m in mk])
    got = ServeEngine(pparams, cfg, T, max_seq=s + 8, slots=2).generate(
        [Request(rid=i, prompt=p, max_new=m) for i, p, m in mk])
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].dtype == np.int32
        np.testing.assert_array_equal(got[rid], want[rid])


def test_generate_bf16_follows_its_own_prefill(pair):
    dtype, _, _, pcfg, pparams = pair
    prompts = _tokens(3, 12, pcfg.vocab, seed=5)
    eng = ServeEngine(pparams, pcfg, T, max_seq=24, slots=4)
    out = eng.generate([Request(rid=i, prompt=prompts[i], max_new=6) for i in range(3)])
    _, logits = T.prefill(pparams, torch.from_numpy(prompts), pcfg)
    first = logits.argmax(-1).tolist()
    for i in range(3):
        assert out[i].shape == (6,) and out[i][0] == first[i]
        assert ((out[i] >= 0) & (out[i] < pcfg.vocab)).all()
    assert all(np.array_equal(out[i], o) for i, o in eng.generate(
        [Request(rid=i, prompt=prompts[i], max_new=6) for i in range(3)]).items())
    with pytest.raises(ValueError):
        eng.generate([Request(rid=i, prompt=prompts[0]) for i in range(5)])


def test_prefill_backends_agree(pair):
    """``attn_backend`` picks flash_torch or the materializing oracle; in
    float32 both give the same logits to float32 rounding."""
    dtype, _, _, pcfg, pparams = pair
    toks = torch.from_numpy(_tokens(2, 40, pcfg.vocab, seed=9))
    kv_a, a = T.prefill(pparams, toks, pcfg, attn_backend="naive")
    kv_b, b = T.prefill(pparams, toks, pcfg, attn_backend="flash_torch")
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def test_cache_update_add_matches_reference():
    rng = np.random.default_rng(4)
    cache = np.zeros((2, 3, 7, 4), np.float32)
    cache[:, :, :3] = rng.normal(size=(2, 3, 3, 4))
    new = rng.normal(size=(2, 3, 4)).astype(np.float32)
    want = RT.cache_update_add(jnp.asarray(cache), jnp.asarray(new), 3)
    got = T.cache_update_add(torch.from_numpy(cache.copy()), torch.from_numpy(new), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
