"""The port's architecture registry, the LM configs' parameter counts and
the minitron configs against the reference, on the CPU.

``ARCHS()`` lists what the port registers; the reference archs still
missing are named here with the ROADMAP item that ports them.  The
minitron SMOKE prefill is held against the reference with the params of
the reference's ``init``, at the tolerances of
``tests/test_torch_transformer.py``: float32 logits within atol = rtol =
1e-4 (the same arithmetic in another summation order), bf16 within atol =
0.06, rtol = 0.05 (the two frameworks round bf16 at different places).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import transformer_params_from_arrays  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

#: reference archs the port does not register yet -> the ROADMAP item
#: (Queue 1, item 8) that ports them: none since paper-gwq joined
MISSING = {}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}


def test_archs_are_the_reference_archs_less_the_missing_ones():
    ref = r_registry.ARCHS()
    assert registry.ARCHS() == [a for a in ref if a not in MISSING]
    assert set(MISSING) <= set(ref)


def test_missing_archs_are_named_in_the_roadmap():
    import pathlib

    text = (pathlib.Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    for arch, item in MISSING.items():
        mod = r_registry.ARCH_MODULES[arch].rsplit(".", 1)[1]
        assert mod in text, arch
        assert f"**({item[-1]})" in text, item


@pytest.mark.parametrize("name", [a for a in r_registry.ARCHS() if a not in MISSING])
def test_registered_spec_matches_reference(name):
    mine, ref = registry.get_arch(name), r_registry.get_arch(name)
    assert (mine.name, mine.family, set(mine.skip)) == \
        (ref.name, ref.family, set(ref.skip))
    assert {k: (v.kind, v.dims) for k, v in mine.shapes.items()} == \
        {k: (v.kind, v.dims) for k, v in ref.shapes.items()}
    for attr in ("model_cfg", "smoke_cfg"):
        got, want = getattr(mine, attr), getattr(ref, attr)
        if not dataclasses.is_dataclass(want):  # paper-gwq: its shape table, no smoke
            assert _shape_table(got) == _shape_table(want), (name, attr)
            continue
        assert dataclasses.asdict(got) == \
            {k: v for k, v in dataclasses.asdict(want).items()
             if k in dataclasses.asdict(got)}, (name, attr)


def _shape_table(cfg):
    if cfg is None:
        return None
    return {k: (v.name, v.kind, v.dims, v.comment) for k, v in cfg.items()}


@pytest.mark.parametrize("name", ["minitron-4b", "qwen3-0.6b", "minitron-8b",
                                  "grok-1-314b", "qwen2-moe-a2.7b"])
def test_lm_param_counts_match_reference(name):
    mine, ref = registry.get_arch(name).model_cfg, r_registry.get_arch(name).model_cfg
    assert mine.n_params() == ref.n_params()
    if hasattr(ref, "n_active_params"):  # the MoE configs
        assert mine.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("name", ["minitron-4b", "minitron-8b"])
def test_minitron_configs_take_k3s_sm90_route(name):
    """head_dim 128 and no sliding window: K3's tensor-core route."""
    from repro_torch.kernels.flash_attention.flash_attention import route

    cfg = registry.get_arch(name).model_cfg
    ref = r_registry.get_arch(name).model_cfg
    assert cfg.head_dim == ref.head_dim == 128 and cfg.local_window is None
    assert cfg.n_params() == ref.n_params()
    assert route(cfg.cdtype, cfg.head_dim) == "sm90"
    smoke = registry.get_arch(name).smoke_cfg
    assert smoke.remat is False and cfg.remat is True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mod", ["minitron_4b", "minitron_8b"])
def test_minitron_smoke_prefill_matches_reference(mod, dtype):
    rmod = importlib.import_module(f"repro.configs.{mod}")
    pmod = importlib.import_module(f"repro_torch.configs.{mod}")
    rcfg = dataclasses.replace(rmod.SMOKE, compute_dtype=dtype)
    pcfg = dataclasses.replace(pmod.SMOKE, compute_dtype=dtype)
    rparams = RT.init(jax.random.PRNGKey(1), rcfg)
    pparams = transformer_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                             torch_device="cpu")
    toks = np.random.default_rng(3).integers(0, pcfg.vocab, (2, 40)).astype(np.int32)
    _, want = RT.prefill(rparams, jax.numpy.asarray(toks), rcfg)
    _, got = T.prefill(pparams, torch.from_numpy(toks).long(), pcfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])
