"""The MoE serving path (qwen2-moe-a2.7b and grok-1-314b SMOKE), port vs
reference, on the CPU.

The reference's ``moe.init`` params are carried across with
``convert.moe_params_from_arrays``; inputs are drawn with numpy from a seed.

The dispatch is held bitwise: on inputs whose every product and sum is
exact in float32 (small integers; router logits 0 or 256, so the softmax
is exactly 1/K on the chosen experts and 0 elsewhere; the gate input of
each expert 0 or >= 20, where silu is the identity to the last bit), the
port's batched dispatch over G groups must give the reference's
``_dispatch_group`` of each group to the bit, in float32 and in bf16 (where
the combine's order of adds shows: each token's contributions in ascending
expert order, rounded after each add).

The model paths are held at the tolerances of
``tests/test_torch_transformer.py``: float32 within atol = rtol = 1e-4,
bf16 within atol = 0.06, rtol = 0.05.  A route is discrete: where the two
packages' hidden states differ by a rounding step, a token whose k-th and
(k+1)-th router logits are that close can take another expert, and its
row then moves by far more than any rounding.  So each comparison runs
the port twice.  The first run routes on its own; both packages' routing
is recorded at every layer (the reference's router logits by an ordered
``jax.debug.callback`` in a wrapper of its ``_dispatch_group``), and at
each row's first layer where the port chose another expert set, the
reference's logits must have been a near tie (``moe.route_flips``: a gap
within what the logits moved between the packages at that layer).  The
second run takes the reference's experts at every layer, and its outputs
are held to the tolerance everywhere.
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
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs import grok1_314b as P_GROK  # noqa: E402
from repro_torch.configs import qwen2_moe_a2p7b as P_QWEN  # noqa: E402
from repro_torch.convert import moe_params_from_arrays  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.06, rtol=0.05)}
ARCHS = {"qwen2-moe": (R_QWEN, P_QWEN), "grok-1": (R_GROK, P_GROK)}
EXPERT_WEIGHTS = ("we_gate", "we_up", "we_down")
SHARED_WEIGHTS = ("ws_gate", "ws_up", "ws_down")


def _cfgs(arch, dtype, **kw):
    rmod, pmod = ARCHS[arch]
    return (dataclasses.replace(rmod.SMOKE, compute_dtype=dtype, **kw),
            dataclasses.replace(pmod.SMOKE, compute_dtype=dtype, **kw))


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(dtype, reference cfg, reference params, port cfg, port params)."""
    arch, dtype = request.param
    rcfg, pcfg = _cfgs(arch, dtype)
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    pparams = moe_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                     torch_device="cpu")
    return dtype, rcfg, rparams, pcfg, pparams


@pytest.fixture
def routes(monkeypatch):
    """Both packages' routing at every dispatch, in call order: ``"ref"``,
    the reference's router logits, [t, E] per group; ``"port"``, the port's
    ([T, E] logits, [T, K] experts) per call.  While ``"follow"`` holds
    experts ([T, K] per call), the port's router takes them in turn instead
    of its own top-k, and records nothing."""
    rec = {"ref": [], "port": [], "follow": []}
    ref_dispatch, port_route = RM._dispatch_group, M._route

    def ref_wrapped(xt, router, *args, **kw):
        cfg = args[4]
        logits = (xt @ router.astype(cfg.cdtype)).astype(jnp.float32)
        jax.debug.callback(lambda a: rec["ref"].append(np.asarray(a)), logits,
                           ordered=True)
        return ref_dispatch(xt, router, *args, **kw)

    def port_wrapped(xt, router, cfg):
        if rec["follow"]:
            experts = rec["follow"].pop(0).view(xt.shape[0], xt.shape[1], cfg.top_k)
            return port_route(xt, router, cfg, experts)
        out = port_route(xt, router, cfg)
        rec["port"].append(((xt @ router).float().reshape(-1, router.shape[1]),
                            out[0].reshape(-1, cfg.top_k)))
        return out

    monkeypatch.setattr(RM, "_dispatch_group", ref_wrapped)
    monkeypatch.setattr(M, "_route", port_wrapped)
    return rec


def _ref_experts(logits, cfg):
    """The reference's top-k on its recorded logits, as ``_dispatch_group``
    takes it."""
    lg = jnp.asarray(logits)
    if cfg.n_experts_padded != cfg.n_experts:
        lg = jnp.where(jnp.arange(cfg.n_experts_padded) < cfg.n_experts, lg, -1e30)
    return np.array(jax.lax.top_k(jax.nn.softmax(lg, axis=-1), cfg.top_k)[1])


def _routes_checked(rec, cfg, calls):
    """Check the routing of the calls recorded in ``rec`` (each ``(b, s)``
    of ``calls`` ran ``cfg.n_layers`` dispatches over ``[b, s]`` tokens;
    consumed): at each row's first layer where the port chose another
    expert set than the reference, the reference's logits were a near tie
    there (``moe.route_flips``).  Returns the reference's experts, [T, K]
    per call and layer, for ``rec["follow"]``."""
    follow = []
    for b, s in calls:
        t = b * s
        g = M.group_count(t, cfg)
        assert s % (t // g) == 0, "a dispatch group crosses rows"
        n = cfg.n_layers * g  # one reference record a group
        ref = torch.from_numpy(np.concatenate(rec["ref"][:n]).reshape(cfg.n_layers, t, -1))
        port = rec["port"][:cfg.n_layers]
        del rec["ref"][:n], rec["port"][:cfg.n_layers]
        logits = torch.stack([lg for lg, _ in port])
        experts = torch.stack([idx for _, idx in port])
        assert experts.shape == (cfg.n_layers, t, cfg.top_k)
        # recorded in step: the first layer's logits differ by rounding alone
        _close(logits[0].numpy(), ref[0].numpy(), cfg.compute_dtype)
        want = torch.from_numpy(_ref_experts(ref.numpy(), cfg)).long()
        flips = M.route_flips(ref, want, logits, experts, b)
        assert all(ratio <= 1 for *_, ratio in flips["first_flips"]), flips["first_flips"]
        follow.extend(want)
    return follow


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ------------------------------ configs --------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_init_match_reference(arch):
    rmod, pmod = ARCHS[arch]
    for attr in ("CONFIG", "SMOKE") + (("CONFIG_EP",) if arch == "qwen2-moe" else ()):
        mine, ref = getattr(pmod, attr), getattr(rmod, attr)
        fields = dataclasses.asdict(mine)  # every port field equals the reference's
        assert fields == {k: v for k, v in dataclasses.asdict(ref).items() if k in fields}
        assert mine.n_experts_padded == ref.n_experts_padded
        assert (mine.n_params(), mine.n_active_params()) == \
            (ref.n_params(), ref.n_active_params())
    cfg = pmod.SMOKE
    params = M.init(torch.Generator().manual_seed(0), cfg)
    lp = params["layers"][0]
    n = sum(t.numel() for p in params["layers"] for t in p.values())
    n += sum(params[k].numel() for k in ("embed", "unembed", "ln_f") if k in params)
    assert n == cfg.n_params()
    for name in M.MOE_WEIGHTS + ("wq", "embed"):
        w = lp.get(name, params.get(name))
        if w is not None:
            assert w.dtype == cfg.cdtype, name
    assert lp["ln1"].dtype == cfg.pdtype
    assert lp["we_gate"].shape == (cfg.n_experts_padded, cfg.d_model, cfg.d_ff)
    # the reference's scale: unit normals over sqrt(d_in)
    assert abs(float(lp["we_down"].float().std()) * cfg.d_ff ** 0.5 - 1) < 0.05


def test_grok_holds_every_param_in_bf16():
    cfg = P_GROK.CONFIG
    assert cfg.pdtype == torch.bfloat16 and cfg.attn_kv_chunk == 2048
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) == (6, 128)
    rcfg, pcfg = _cfgs("grok-1", "bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0), rcfg))
    params = moe_params_from_arrays(tree, pcfg, torch_device="cpu")
    assert {t.dtype for p in params["layers"] for t in p.values()} == {torch.bfloat16}
    np.testing.assert_array_equal(params["layers"][1]["we_up"].float().numpy(),
                                  tree["layers"]["we_up"][1].astype(np.float32))


# ------------------------------ dispatch -------------------------------- #
def test_segment_positions_match_reference():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 7, (5, 64)), axis=-1)
    ids[1] = 3  # one run
    ids[2] = np.arange(64)  # all runs of one
    got = M._segment_positions(torch.from_numpy(ids)).numpy()
    for row in range(ids.shape[0]):
        np.testing.assert_array_equal(
            got[row], np.asarray(RM._segment_positions(jnp.asarray(ids[row]))))


def _exact_case(cfg, g, t, rng, chosen):
    """Inputs on which every operation of the dispatch is exact in float32:
    ``chosen(token) -> expert ids`` sets each token's router logits to 256
    on those experts, 0 elsewhere (pad experts, if any, 512: the mask must
    keep them out).  Returns (xt [g, t, d] float32, layer params as float32
    numpy)."""
    d, e, ep = cfg.d_model, cfg.n_experts, cfg.n_experts_padded
    x = np.zeros((g * t, d), np.float32)
    for i in range(g * t):
        x[i, chosen(i)] = 1.0
    x[:, e + 1:] = rng.integers(0, 3, (g * t, d - e - 1))
    x[:, e] = 1.0
    router = np.zeros((d, ep), np.float32)
    router[np.arange(e), np.arange(e)] = 256.0
    router[e, e:] = 512.0
    f, fs = cfg.d_ff, cfg.d_ff_shared
    lp = {"router": router,
          "we_gate": 20.0 * rng.integers(0, 2, (ep, d, f)),
          "we_up": rng.integers(-2, 3, (ep, d, f)),
          "we_down": rng.integers(-1, 2, (ep, f, d)),
          "ws_gate": 20.0 * rng.integers(0, 2, (d, fs)),
          "ws_up": rng.integers(-2, 3, (d, fs)),
          "ws_down": rng.integers(-1, 2, (fs, d))}
    return x.reshape(g, t, d), {k: v.astype(np.float32) for k, v in lp.items()}


def _port_layer(lp, cfg):
    return {k: torch.from_numpy(v).to(M.port_dtype(k, cfg)) for k, v in lp.items()}


def _ref_groups(xt, lp, cfg):
    shared = (tuple(jnp.asarray(lp[k]) for k in SHARED_WEIGHTS)
              if cfg.n_shared_experts else None)
    outs, auxes = [], []
    for xg in xt:
        out, aux = RM._dispatch_group(jnp.asarray(xg, cfg.cdtype), jnp.asarray(lp["router"]),
                                      *(jnp.asarray(lp[k]) for k in EXPERT_WEIGHTS),
                                      shared, cfg)
        outs.append(np.asarray(out.astype(jnp.float32)))
        auxes.append(float(aux))
    return np.stack(outs), np.array(auxes, np.float32)


DISPATCH_CASES = {
    # (groups, tokens a group, arch, extra config, token -> experts)
    "spread": (3, 16, "qwen2-moe", {},
               lambda i: np.random.default_rng(i).choice(6, 4, replace=False)),
    # every token of a group on the same experts: 16 > capacity 14
    "overflow": (2, 16, "qwen2-moe", {}, lambda i: [0, 2, 3, 5]),
    # half the tokens on experts 1 and 2 (9 > capacity 6), half spread
    "overflow_grok": (4, 18, "grok-1", {},
                      lambda i: [1, 2] if i % 2 else
                      np.random.default_rng(i).choice(4, 2, replace=False)),
    # 6 experts padded to 8; the pad experts' logits would win unmasked
    "pad": (2, 12, "qwen2-moe", {"pad_experts_to": 8},
            lambda i: np.random.default_rng(i).choice(6, 4, replace=False)),
}


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_bitwise_reference_with_identical_routing(case, dtype):
    """All G groups at once, bitwise each group's ``_dispatch_group``: the
    same tokens kept and dropped, the same combine order."""
    g, t, arch, extra, chosen = DISPATCH_CASES[case]
    rcfg, pcfg = _cfgs(arch, dtype, d_model=24, d_ff=8, d_ff_shared=16, **extra)
    xt, lp = _exact_case(pcfg, g, t, np.random.default_rng(1), chosen)
    want, want_aux = _ref_groups(xt, lp, rcfg)
    plp = _port_layer(lp, pcfg)
    xt_t = torch.from_numpy(xt).to(pcfg.cdtype)
    got, aux = M._dispatch(xt_t, plp, pcfg)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=1e-6)
    experts, gates, _ = M._route(xt_t, plp["router"], pcfg)
    assert int(experts.max()) < pcfg.n_experts  # never a pad expert
    assert torch.equal(gates, torch.full_like(gates, 1 / pcfg.top_k))
    slot = M._slots(experts, M.capacity(t, pcfg), pcfg.n_experts_padded)
    dropped = int((slot == pcfg.n_experts_padded * g * M.capacity(t, pcfg)).sum())
    assert (dropped > 0) == case.startswith("overflow"), dropped


def test_config_ep_never_routes_to_a_pad_expert():
    """CONFIG_EP (60 experts padded to 64) at its full width: pad columns
    whose logits would win unmasked are never chosen, and the choice is
    the reference's top-k on the masked logits."""
    cfg = P_QWEN.CONFIG_EP
    rng = np.random.default_rng(4)
    router = rng.normal(size=(cfg.d_model, 64)).astype(np.float32) * 0.02
    router[0, 60:] = 1.0
    xt = rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    xt[..., 0] = 50.0
    x_p, r_p = (torch.from_numpy(a).to(cfg.cdtype) for a in (xt, router))
    experts, gates, _ = M._route(x_p, r_p, cfg)
    assert int(experts.max()) < 60
    logits = (x_p @ r_p).float().numpy()
    assert (logits[..., 60:].min(-1) > logits[..., :60].max(-1)).all()  # pads would win
    np.testing.assert_array_equal(experts.numpy(), _ref_experts(logits, R_QWEN.CONFIG_EP))
    assert torch.allclose(gates.sum(-1), torch.ones(()))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_take_the_reference_experts(arch, dtype):
    """Router columns repeated in triples, so every token's logits tie in
    threes across the k-th boundary: the lower expert index wins, as
    ``lax.top_k`` takes it (``torch.topk`` promises no order)."""
    rcfg, pcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(2)
    router = rng.normal(size=(pcfg.d_model, pcfg.n_experts)).astype(np.float32) * 0.02
    router[:, 1] = router[:, 2] = router[:, 0]
    if pcfg.n_experts == 6:
        router[:, 4] = router[:, 5] = router[:, 3]
    xt = rng.normal(size=(4, 20, pcfg.d_model)).astype(np.float32)
    x_r = jnp.asarray(xt, rcfg.cdtype)
    ref_logits = np.asarray((x_r @ jnp.asarray(router, rcfg.cdtype)).astype(jnp.float32))
    assert (ref_logits[..., 0] == ref_logits[..., 2]).all()  # the ties are real
    want = _ref_experts(ref_logits, rcfg)
    x_p = torch.from_numpy(xt).to(pcfg.cdtype)
    got, gates, _ = M._route(x_p, torch.from_numpy(router).to(pcfg.cdtype), pcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got[..., :, None] == got[..., None, :]).sum(-1).gt(1).any()
    # every token's k-th and (k+1)-th logits tie: top-k broke a tie for each
    assert (M.router_gap_steps(torch.from_numpy(ref_logits.copy()), pcfg.top_k,
                               pcfg.cdtype) == 0).all()


@pytest.mark.parametrize("t", [1536, 1030, 1539, 7])
def test_group_count_when_tokens_do_not_divide_512(t):
    """grok-1 SMOKE's moe_ffn on t tokens (one row): the reference's group
    count (512, lowered until it divides t) decides the capacity; with
    seven tokens in eight on the same two experts, drops show it, bitwise."""
    rcfg, pcfg = _cfgs("grok-1", "float32", d_model=24, d_ff=8)
    g = M.group_count(t, pcfg)
    assert t % g == 0 and g <= 512 and not any(t % h == 0 for h in range(g + 1, 513))
    xt, lp = _exact_case(pcfg, 1, t, np.random.default_rng(3),
                         lambda i: [0, 3] if i % 8 == 0 else [1, 2])
    x = xt.reshape(1, t, -1)
    cap = M.capacity(t // g, pcfg)
    experts, _, _ = M._route(torch.from_numpy(xt.reshape(g, t // g, -1)),
                             torch.from_numpy(lp["router"]), pcfg)
    dropped = int((M._slots(experts, cap, pcfg.n_experts) == pcfg.n_experts * g * cap).sum())
    assert (dropped > 0) == (t > 7), dropped
    want, want_aux = RM.moe_ffn({k: jnp.asarray(v) for k, v in lp.items()},
                                jnp.asarray(x), rcfg)
    got, aux = M.moe_ffn(_port_layer(lp, pcfg), torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_a_mesh_raises_not_implemented():
    """The MoE functions take no ``mesh=``: a mesh reaches them through
    ``acts["moe_shard"]``, as in the reference, and on plain tensors (a
    mesh of one device) that branch is the dispatch one group at a time:
    float32, within 1e-6 of all groups at once (``tests/
    test_torch_lm_steps.py`` holds it over meshes)."""
    _, cfg = _cfgs("grok-1", "float32")
    params = M.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with pytest.raises(TypeError):
        M.moe_ffn(params["layers"][0], x, cfg, mesh=object())
    with pytest.raises(TypeError):
        M.prefill(params, torch.zeros((1, 4), dtype=torch.long), cfg, mesh=object())
    got, aux = M.moe_ffn(params["layers"][0], x, cfg,
                         acts={"moe_shard": (None, ("data",), "model")})
    want, want_aux = M.moe_ffn(params["layers"][0], x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=0)


# ------------------------------ the model ------------------------------- #
@pytest.mark.parametrize("s", [40, 1536])
def test_forward_matches_reference(pair, routes, s):
    """Routing checked on the port's own run; values on a second run that
    takes the reference's experts, so the two differ by rounding alone."""
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = torch.from_numpy(_tokens(2, s, pcfg.vocab, seed=s + 1))
    want, want_aux = RM.forward(rparams, jnp.asarray(toks.numpy()), rcfg)
    M.forward(pparams, toks, pcfg)
    routes["follow"] = _routes_checked(routes, pcfg, [(2, s)])
    got, aux = M.forward(pparams, toks, pcfg)
    assert not routes["follow"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)


@pytest.mark.parametrize("s", [40, 1536])
def test_prefill_matches_reference(pair, routes, s):
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = torch.from_numpy(_tokens(2, s, pcfg.vocab, seed=s))
    rkv, rlogits = RM.prefill(rparams, jnp.asarray(toks.numpy()), rcfg)
    M.prefill(pparams, toks, pcfg)
    routes["follow"] = _routes_checked(routes, pcfg, [(2, s)])
    kv, logits = M.prefill(pparams, toks, pcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, pcfg.vocab)
    _close(logits.numpy(), rlogits, dtype)
    for name in ("k", "v"):
        assert kv[name].shape == rkv[name].shape
        _close(kv[name].float().numpy(), rkv[name].astype(jnp.float32), dtype)


@pytest.mark.parametrize("s", [40])
def test_decode_step_matches_reference(pair, routes, s):
    """Both packages decode one token a row against the reference's
    prefill cache."""
    dtype, rcfg, rparams, pcfg, pparams = pair
    toks = _tokens(2, s, pcfg.vocab, seed=s + 2)
    rkv, rlogits = RM.prefill(rparams, jnp.asarray(toks), rcfg)
    rkv = {k: jnp.pad(v, ((0, 0),) * 3 + ((0, 4), (0, 0))) for k, v in rkv.items()}
    nxt = np.asarray(jnp.argmax(rlogits, -1)).astype(np.int32)
    routes["ref"].clear()
    rlog2, rkv2 = RM.decode_step(rparams, jnp.asarray(nxt), rkv, s, rcfg)

    def cache():
        return {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(pcfg.cdtype)
                for k, v in rkv.items()}

    M.decode_step(pparams, torch.from_numpy(nxt), cache(), s, pcfg)
    routes["follow"] = _routes_checked(routes, pcfg, [(2, 1)])
    log2, kv2 = M.decode_step(pparams, torch.from_numpy(nxt), cache(), s, pcfg)
    _close(log2.numpy(), rlog2, dtype)
    for name in ("k", "v"):
        _close(kv2[name].float().numpy(), rkv2[name].astype(jnp.float32), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_float32(arch, routes):
    """Ragged prompts, right-padded with token 0 in both engines: the
    port's own run routes as the reference does up to near ties, a run
    that takes the reference's experts gives the reference's tokens, and
    a second call gives the same tokens again."""
    rcfg, pcfg = _cfgs(arch, "float32")
    rparams = RM.init(jax.random.PRNGKey(1), rcfg)
    pparams = moe_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                     torch_device="cpu")
    prompts = _tokens(2, 12, pcfg.vocab, seed=7)
    mk = [(i, prompts[i, :n], 5 - i) for i, n in enumerate((12, 9))]
    want = RServeEngine(rparams, rcfg, RM, max_seq=20, slots=2).generate(
        [RRequest(rid=i, prompt=p, max_new=m) for i, p, m in mk])
    eng = ServeEngine(pparams, pcfg, M, max_seq=20, slots=2)
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, p, m in mk]
    free = eng.generate(reqs)
    # the prefill, then 4 decode steps (max_new 5)
    routes["follow"] = _routes_checked(routes, pcfg, [(2, 12)] + [(2, 1)] * 4)
    got = eng.generate(reqs)
    assert not routes["follow"]
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].dtype == np.int32
        np.testing.assert_array_equal(got[rid], want[rid])
    again = eng.generate(reqs)
    assert all(np.array_equal(again[rid], free[rid]) for rid in free)


def test_generate_follows_its_own_prefill(pair):
    dtype, _, _, pcfg, pparams = pair
    prompts = _tokens(3, 12, pcfg.vocab, seed=5)
    eng = ServeEngine(pparams, pcfg, M, max_seq=24, slots=4)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=6) for i in range(3)]
    out = eng.generate(reqs)
    _, logits = M.prefill(pparams, torch.from_numpy(prompts), pcfg)
    for i in range(3):
        assert out[i].shape == (6,) and out[i][0] == int(logits[i].argmax())
        assert ((out[i] >= 0) & (out[i] < pcfg.vocab)).all()
    again = eng.generate(reqs)
    assert all(np.array_equal(again[i], o) for i, o in out.items())


def test_router_gap_steps():
    logits = torch.tensor([[4.0, 4.0, 1.0], [4.0, 3.984375, 0.0], [2.0, 1.0, 0.5]])
    gaps = M.router_gap_steps(logits, 1, torch.bfloat16)
    # a tie; a gap of half a bf16 step at 4 (2**-7 * 4); 1 over steps of 2**-6
    np.testing.assert_allclose(gaps.numpy(), [0.0, 0.5, 64.0])
