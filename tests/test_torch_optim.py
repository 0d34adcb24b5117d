"""Optimizers, schedules, clipping and int8 compression: port vs reference,
on the CPU.

The same numpy params and gradients go through the reference's pure
transforms and the port's; after 10 updates the params and float32 state
must agree within rtol 1e-6 / atol 1e-7, and bf16 moments be equal or one
bf16 step apart (the two frameworks' float32 pow and sqrt may differ in
the last bit, and a moment on a rounding boundary then rounds the other
way).  int8 quantization is held bitwise: both round half to even.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import grad_compress as RG  # noqa: E402
from repro.optim import optimizers as RO  # noqa: E402
from repro.optim import schedules as RS  # noqa: E402

from repro_torch.optim import grad_compress as PG  # noqa: E402
from repro_torch.optim import optimizers as PO  # noqa: E402
from repro_torch.optim import schedules as PS  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    """A nested params-like tree of float32 numpy arrays (a matrix stack, a
    matrix, a vector, a list)."""
    return {"w": (rng.normal(size=(3, 8, 5)) * scale).astype(np.float32),
            "emb": (rng.normal(size=(16, 4)) * scale).astype(np.float32),
            "norm": {"g": (1 + 0.1 * rng.normal(size=(5,)) * scale).astype(np.float32)},
            "mlp": [{"b": (rng.normal(size=(7,)) * scale).astype(np.float32)},
                    {"b": (rng.normal(size=(2,)) * scale).astype(np.float32)}]}


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_torch(v) for v in t]
    return torch.from_numpy(np.array(t))


def _flat_ref(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _flat_port(tree):
    return [x.detach().float().numpy() for x in leaves(tree)]


def _bf16_steps_apart(a, b):
    """How many bf16 steps apart two arrays of bf16 values (as float32) are."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64) >> 16
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64) >> 16
    return np.abs(ia - ib)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    for rfn, pfn in ((RS.linear_warmup(3e-4, 10), PS.linear_warmup(3e-4, 10)),
                     (RS.cosine_schedule(3e-4, 20, 100), PS.cosine_schedule(3e-4, 20, 100)),
                     (RS.cosine_schedule(1.0, 0, 7, 0.2), PS.cosine_schedule(1.0, 0, 7, 0.2))):
        want = np.float32(rfn(jnp.asarray(step, jnp.int32)))
        got = pfn(step)
        assert got.dtype == torch.float32
        assert float(pfn(torch.tensor(step, dtype=torch.int32))) == float(got)
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=1e-12)


def test_tree_order_is_jax_order():
    rng = np.random.default_rng(0)
    t = _tree(rng)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    port = [x.numpy() for _, x in flatten_with_paths(_to_torch(t))]
    assert len(ref) == len(port)
    assert all(np.array_equal(a, b) for a, b in zip(ref, port))


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    t = _tree(np.random.default_rng(1), scale=3.0)
    rc, rn = RO.clip_by_global_norm(_to_jax(t), max_norm)
    pc, pn = PO.clip_by_global_norm(_to_torch(t), max_norm)
    np.testing.assert_allclose(float(pn), float(rn), rtol=RTOL)
    for a, b in zip(_flat_ref(rc), _flat_port(pc)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


OPTS = {
    "adamw": (lambda: RO.adamw(1e-2), lambda: PO.adamw(1e-2)),
    "adamw_f32_moments": (lambda: RO.adamw(1e-2, moment_dtype=jnp.float32, clip_norm=None),
                          lambda: PO.adamw(1e-2, moment_dtype=torch.float32, clip_norm=None)),
    "adamw_cosine": (lambda: RO.adamw(RS.cosine_schedule(3e-2, 3, 10)),
                     lambda: PO.adamw(PS.cosine_schedule(3e-2, 3, 10))),
    "adafactor": (lambda: RO.adafactor(5e-2), lambda: PO.adafactor(5e-2)),
    "sgd": (lambda: RO.sgd(1e-2), lambda: PO.sgd(1e-2)),
    "sgd_clipped": (lambda: RO.sgd(1e-2, clip_norm=0.5), lambda: PO.sgd(1e-2, clip_norm=0.5)),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_ten_updates_match_reference(name):
    """10 updates on the same gradients: params, float32 state and the
    global norm within rtol 1e-6 / atol 1e-7; bf16 moments equal or one
    bf16 step apart."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.5) for _ in range(10)]
    ropt, popt = (f() for f in OPTS[name])
    rp, pp = _to_jax(params), _to_torch(params)
    rs, ps = ropt.init(rp), popt.init(pp)
    for g in grads:
        rp, rs, rn = ropt.update(_to_jax(g), rs, rp)
        pp, ps, pn = popt.update(_to_torch(g), ps, pp)
        np.testing.assert_allclose(float(pn), float(rn), rtol=RTOL)
    for a, b in zip(_flat_ref(rp), _flat_port(pp)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert int(ps.step) == int(rs.step) == 10
    rleaves = jax.tree_util.tree_leaves(rs)[1:]
    pleaves = leaves(ps)[1:]
    assert len(rleaves) == len(pleaves)
    for a, b in zip(rleaves, pleaves):
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            assert _bf16_steps_apart(np.asarray(a, np.float32), b.float().numpy()).max() <= 1
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    popt = {"adamw": lambda: PO.adamw(1e-1), "sgd": lambda: PO.sgd(1e-2),
            "adafactor": lambda: PO.adafactor(5e-1)}[name]()
    params = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32))}
    state = popt.init(params)

    def loss(p):
        return torch.sum(torch.square(p["w"] - 3.0))

    l0 = float(loss(params))
    for _ in range(60):
        params, state, _ = popt.update({"w": 2 * (params["w"] - 3.0)}, state, params)
    assert float(loss(params)) < 0.5 * l0


def test_adamw_moments_bf16_and_inputs_untouched():
    opt = PO.adamw(1e-3)
    params = {"w": torch.ones((4, 4))}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.bfloat16 and state.nu["w"].dtype == torch.bfloat16
    new, _, _ = opt.update({"w": torch.ones((4, 4))}, state, params)
    assert torch.equal(params["w"], torch.ones((4, 4)))  # pure: the input is not updated
    assert not torch.equal(new["w"], params["w"])


def test_apply_updates():
    p = {"a": torch.ones(3), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    u = {"a": torch.full((3,), 0.5), "b": [torch.ones(2)]}
    out = PO.apply_updates(p, u)
    assert torch.equal(out["a"], torch.full((3,), 1.5))
    assert out["b"][0].dtype == torch.bfloat16 and torch.equal(out["b"][0].float(), torch.ones(2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantize_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    # values exactly on .5 steps of the scale: round half to even
    x[:4] = np.float32(127.0) * np.array([1.0, 0.5 / 127, 1.5 / 127, -2.5 / 127], np.float32)
    rq, rs = RG.quantize_int8(jnp.asarray(x))
    pq, ps = PG.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert np.float32(ps).tobytes() == np.float32(rs).tobytes()
    assert np.array_equal(PG.dequantize_int8(pq, ps).numpy(),
                          np.asarray(RG.dequantize_int8(rq, rs)))


def test_int8_compress_hook_trajectory_bitwise():
    """Five rounds of the error-feedback hook on a tree: the decompressed
    gradients and the residuals bitwise the reference's."""
    rng = np.random.default_rng(3)
    grads = [_tree(rng) for _ in range(5)]
    rerr = RG.init_error_feedback(_to_jax(grads[0]))
    perr = PG.init_error_feedback(_to_torch(grads[0]))
    for g in grads:
        rdec, rerr = RG.int8_compress_hook(_to_jax(g), rerr)
        pdec, perr = PG.int8_compress_hook(_to_torch(g), perr)
        for a, b in zip(_flat_ref(rdec) + _flat_ref(rerr), _flat_port(pdec) + _flat_port(perr)):
            assert np.array_equal(a, b)


def test_int8_compression_error_feedback_converges():
    g_true = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    err = PG.init_error_feedback({"g": g_true})["g"]
    total = torch.zeros_like(g_true)
    for _ in range(50):
        dec, e = PG.int8_compress_hook({"g": g_true}, {"g": err})
        err = e["g"]
        total = total + dec["g"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(), atol=1e-2)


def test_adamw_state_crosses_both_ways_mid_run():
    """Three reference updates, the params and AdamWState carried across to
    the port (``convert.tree_from_arrays``, ``adamw_state_from_arrays``),
    three more updates in each package: params and moments agree as in
    the ten-update test; the port's state carried back
    (``adamw_state_to_arrays``) holds the same values it does."""
    from repro_torch.convert import (adamw_state_from_arrays, adamw_state_to_arrays,
                                     tree_from_arrays)

    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    ropt, popt = RO.adamw(1e-2), PO.adamw(1e-2)
    rp = _to_jax(params)
    rs = ropt.init(rp)
    for g in grads[:3]:
        rp, rs, _ = ropt.update(_to_jax(g), rs, rp)
    pp = tree_from_arrays(jax.tree.map(np.asarray, rp), torch_device="cpu")
    ps = adamw_state_from_arrays(rs.step, jax.tree.map(np.asarray, rs.mu),
                                 jax.tree.map(np.asarray, rs.nu), torch_device="cpu")
    assert int(ps.step) == 3 and ps.mu["w"].dtype == torch.bfloat16
    assert np.array_equal(ps.nu["b"].float().numpy(), np.asarray(rs.nu["b"], np.float32))
    for g in grads[3:]:
        rp, rs, _ = ropt.update(_to_jax(g), rs, rp)
        pp, ps, _ = popt.update(_to_torch(g), ps, pp)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=RTOL, atol=ATOL)
    back = adamw_state_to_arrays(ps)
    assert back["step"] == 6
    for k in params:
        assert np.array_equal(back["mu"][k], ps.mu[k].float().numpy())
        assert _bf16_steps_apart(back["nu"][k], np.asarray(rs.nu[k], np.float32)).max() <= 1
