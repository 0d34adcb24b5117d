"""Kernel K4's modules and the FM scoring path, port vs reference, on the CPU.

The port's ``fm_interaction`` (its plain version: the tensors lie on the
CPU) against the reference's Pallas kernel in interpret mode over the
reference sweep's shapes, within rtol = atol = 2e-5 (the reference sweep's
own tolerance: the same float32 sums in another order).  The model path
(``_rows``, ``forward``, ``retrieval_scores``, ``embedding_bag``) runs on
the reference's SMOKE params carried across by ``convert``: row ids must
be equal, scores within rtol = atol = 1e-6 (float32 gathers and short
sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.fm_criteo import CONFIG as R_CONFIG  # noqa: E402
from repro.configs.fm_criteo import SMOKE as R_SMOKE  # noqa: E402
from repro.kernels.fm_interaction.fm_interaction import (  # noqa: E402
    fm_interaction as r_fm_interaction,
)
from repro.models import recsys as RR  # noqa: E402

from repro_torch.configs.fm_criteo import CONFIG, SMOKE  # noqa: E402
from repro_torch.convert import fm_params_from_arrays  # noqa: E402
from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import fm_second_order  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)
EDGE_IDS = [-1, -7, 2**31 - 1, -(2**31), 0, 1, 999, 1000]


@pytest.fixture(scope="module")
def smoke():
    rparams = RR.init(jax.random.PRNGKey(0), R_SMOKE)
    pparams = fm_params_from_arrays(jax.tree.map(np.asarray, rparams), SMOKE,
                                    torch_device="cpu")
    return rparams, pparams


def _ids(b, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, (b, f), dtype=np.int64).astype(np.int32)
    x[0, : min(f, len(EDGE_IDS))] = EDGE_IDS[:f]
    return x


@pytest.mark.parametrize("b,f,k", [(64, 39, 10), (100, 8, 16), (256, 5, 3)])
def test_fm_interaction_matches_pallas_interpret(b, f, k):
    emb = np.random.default_rng(b + f + k).normal(size=(b, f, k)).astype(np.float32)
    ref = r_fm_interaction(jnp.asarray(emb), interpret=True)
    got = fm_interaction(torch.from_numpy(emb))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert torch.equal(fm_second_order(torch.from_numpy(emb)), got)


def test_fm_ref_equals_explicit_pairwise():
    """sum-square trick == O(F^2) pairwise dots (Rendle's identity)."""
    emb = np.random.default_rng(0).normal(size=(10, 6, 4))
    explicit = sum(np.sum(emb[:, i] * emb[:, j], axis=-1)
                   for i in range(6) for j in range(i + 1, 6))
    np.testing.assert_allclose(fm_interaction_ref(torch.from_numpy(emb)).numpy(),
                               explicit, rtol=1e-10)


@pytest.mark.parametrize("cfg,rcfg", [(SMOKE, R_SMOKE), (CONFIG, R_CONFIG)],
                         ids=["smoke", "full"])
def test_rows_match_reference_on_negative_ids(cfg, rcfg):
    x = _ids(16, cfg.n_fields, seed=1)
    got = R._rows(cfg, torch.from_numpy(x))
    want = np.asarray(RR._rows(rcfg, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < cfg.total_rows
    if cfg is SMOKE:  # the reference's rows for the leading edge ids
        assert got[0, :4].tolist() == [295, 1089, 1147, 1248]


@pytest.mark.parametrize("use_pallas_fm", [False, True])
@pytest.mark.parametrize("b", [1, 37, 512])
def test_forward_matches_reference(smoke, use_pallas_fm, b):
    """The port's forward against the reference's, with its FM term from
    the jnp oracle and from the Pallas kernel (interpret mode)."""
    rparams, pparams = smoke
    x = _ids(b, SMOKE.n_fields, seed=b)
    want = RR.forward(rparams, jnp.asarray(x), R_SMOKE, use_pallas_fm=use_pallas_fm)
    got = R.forward(pparams, torch.from_numpy(x), SMOKE)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def test_retrieval_scores_match_reference(smoke):
    rparams, pparams = smoke
    x = _ids(1, SMOKE.n_fields, seed=3)
    cand = np.random.default_rng(3).integers(0, SMOKE.total_rows, 300).astype(np.int32)
    want = RR.retrieval_scores(rparams, jnp.asarray(x), jnp.asarray(cand), R_SMOKE)
    got = R.retrieval_scores(pparams, torch.from_numpy(x), torch.from_numpy(cand), SMOKE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 9, 40)).astype(np.int32)  # bag 9 stays empty
    w = rng.random(40).astype(np.float32) if weighted else None
    want = RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags),
                            10, None if w is None else jnp.asarray(w), mode=mode)
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(bags), 10,
                          None if w is None else torch.from_numpy(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_fm_interaction_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        fm_interaction(torch.zeros((4, 3, 2), dtype=torch.float64))
    with pytest.raises(TypeError):
        fm_interaction(torch.zeros((4, 6)))
    with pytest.raises(ValueError):
        fm_interaction(torch.zeros((4, 2, 3)).transpose(1, 2))
