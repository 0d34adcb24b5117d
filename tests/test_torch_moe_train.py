"""The MoE training loss and its gradients (qwen2-moe-a2.7b and grok-1-314b
SMOKE), port vs reference, on the CPU.

The reference's float32 ``moe.init`` params are carried across with
``convert.lm_train_params_from_arrays``; gradients come back stacked with
``convert.lm_tree_to_arrays``.  A route is discrete, and two correct runs
can route a near-tie token otherwise (``tests/test_torch_moe.py``), so the
reference's routing is recorded (its router logits at every group, by an
ordered ``jax.debug.callback`` in a wrapper of ``_dispatch_group``, in a
forward run) and the port replays the reference's experts at every layer
(``moe._route(experts=)``); the gates and the aux loss still come from
each package's own router probabilities, so the router's gradient is
compared too.  Tolerances: with ``compute_dtype="float32"`` the loss
within rtol 1e-5 and each leaf within atol 1e-5 + rtol 1e-4; in bf16 each
leaf's relative L2 error at most 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import grok1_314b as R_GROK  # noqa: E402
from repro.configs import qwen2_moe_a2p7b as R_QWEN  # noqa: E402
from repro.models import moe as RM  # noqa: E402

from repro_torch.configs import grok1_314b as P_GROK  # noqa: E402
from repro_torch.configs import qwen2_moe_a2p7b as P_QWEN  # noqa: E402
from repro_torch.convert import lm_train_params_from_arrays, lm_tree_to_arrays  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402

ARCHS = {"qwen2-moe": (R_QWEN, P_QWEN), "grok-1": (R_GROK, P_GROK)}


def _ref_experts(logits, cfg):
    lg = jnp.asarray(logits)
    if cfg.n_experts_padded != cfg.n_experts:
        lg = jnp.where(jnp.arange(cfg.n_experts_padded) < cfg.n_experts, lg, -1e30)
    return np.array(jax.lax.top_k(jax.nn.softmax(lg, axis=-1), cfg.top_k)[1])


def _recorded_experts(rparams, tokens, rcfg, monkeypatch):
    """The reference's experts at every layer of a forward over ``tokens``
    ([T, K] per layer, torch int64)."""
    rec = []
    real = RM._dispatch_group

    def wrapped(xt, router, *args, **kw):
        cfg = args[4]
        logits = (xt @ router.astype(cfg.cdtype)).astype(jnp.float32)
        jax.debug.callback(lambda a: rec.append(np.asarray(a)), logits, ordered=True)
        return real(xt, router, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(RM, "_dispatch_group", wrapped)
        jax.block_until_ready(RM.forward_hidden(rparams, jnp.asarray(tokens), rcfg))
        jax.effects_barrier()
    t = tokens.size
    per_layer = np.concatenate(rec).reshape(rcfg.n_layers, t, -1)
    return [torch.from_numpy(_ref_experts(lg, rcfg)).long() for lg in per_layer]


def _following(experts):
    """``moe._route`` taking ``experts`` in turn, one [T, K] a call."""
    queue, real = list(experts), M._route

    def route(xt, router, cfg):
        return real(xt, router, cfg, queue.pop(0).view(xt.shape[0], xt.shape[1], cfg.top_k))
    return route, queue


def _leaves_by_key(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_loss_grads_match_reference(arch, dtype, monkeypatch):
    rmod, pmod = ARCHS[arch]
    rcfg = dataclasses.replace(rmod.SMOKE, compute_dtype=dtype, param_dtype="float32")
    pcfg = dataclasses.replace(pmod.SMOKE, compute_dtype=dtype, param_dtype="float32")
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    experts = _recorded_experts(rparams, toks, rcfg, monkeypatch)
    rl, rg = jax.value_and_grad(
        lambda p: RM.loss_fn(p, jax.tree.map(jnp.asarray, batch), rcfg))(rparams)

    pparams = lm_train_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                          torch_device="cpu")
    route, queue = _following(experts)
    monkeypatch.setattr(M, "_route", route)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pl, pg = value_and_grad(lambda p, b: M.loss_fn(p, b, pcfg), pparams, tb)
    assert not queue  # one replayed routing a layer
    want, got = _leaves_by_key(jax.tree.map(np.asarray, rg)), _leaves_by_key(lm_tree_to_arrays(pg))
    assert want.keys() == got.keys()
    if dtype == "float32":
        np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-4, err_msg=key)
    else:
        np.testing.assert_allclose(float(pl), float(rl), rtol=1e-2)
        for key in want:
            assert _rel_l2(got[key], want[key]) <= 2e-2, (key, _rel_l2(got[key], want[key]))
    for key in ("layers/router", "layers/we_gate", "layers/wq", "embed"):
        assert np.abs(got[key]).max() > 0, key


def test_moe_aux_loss_is_part_of_the_loss():
    """``loss_fn`` is the fused LM loss of ``forward_hidden``'s states plus
    its aux, and the aux carries a gradient to every router."""
    cfg = dataclasses.replace(P_QWEN.SMOKE, compute_dtype="float32")
    params = M.init_master(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        x, aux = M.forward_hidden(params, toks, cfg)
        from repro_torch.models import layers as L
        lm = L.lm_loss_fused(x[:, :-1], params["unembed"], toks[:, 1:], cfg.z_loss)
        assert float(M.loss_fn(params, batch, cfg)) == float(lm + aux)
    _, grads = value_and_grad(lambda p, b: M.forward_hidden(p, b["tokens"], cfg)[1],
                              params, batch)
    assert all(float(lp["router"].abs().sum()) > 0 for lp in grads["layers"])
