"""FM training (the interaction's backward, the loss, its gradients), port
vs reference, on the CPU.

* K4's plain backward (``fm_interaction_bwd`` on CPU tensors) and
  ``FMInteractionFn`` against ``jax.grad`` of the reference's
  ``fm_interaction_ref`` and against the closed form
  ``g[b] * (sum_f' e[b, f', k] - e[b, f, k])``: within 1e-5 of each
  example's magnitude (float32 sums in another order).
* ``recsys.loss_fn`` at the FM's SMOKE config against
  ``jax.value_and_grad`` of the reference's on the same params and batch:
  the loss within rtol 1e-5, each leaf within atol 1e-6 + rtol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.fm_criteo import SMOKE as R_SMOKE  # noqa: E402
from repro.data.pipeline import RecsysStream  # noqa: E402
from repro.kernels.fm_interaction.ref import fm_interaction_ref as r_fm  # noqa: E402
from repro.models import recsys as RR  # noqa: E402

from repro_torch.configs.fm_criteo import SMOKE  # noqa: E402
from repro_torch.convert import fm_params_from_arrays  # noqa: E402
from repro_torch.kernels.fm_interaction import fm_interaction as K4  # noqa: E402
from repro_torch.kernels.fm_interaction.ops import fm_second_order  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402


@pytest.mark.parametrize("b,f,k", [(64, 39, 10), (7, 8, 16), (33, 5, 3), (1, 1, 1)])
def test_k4_plain_backward_matches_reference(b, f, k):
    rng = np.random.default_rng(b + f + k)
    emb = rng.normal(size=(b, f, k)).astype(np.float32)
    g = rng.normal(size=(b,)).astype(np.float32)
    want = np.asarray(jax.grad(lambda e: jnp.sum(r_fm(e) * g))(jnp.asarray(emb)))
    got = K4.fm_interaction_bwd(torch.from_numpy(emb), torch.from_numpy(g)).numpy()
    closed = g[:, None, None] * (emb.sum(1, keepdims=True) - emb)
    mass = np.abs(g)[:, None, None] * (np.abs(emb).sum(1, keepdims=True) + np.abs(emb))
    for other in (want, closed):
        assert (np.abs(got - other) <= 1e-5 * mass + 1e-30).all()


def test_fm_interaction_fn_on_cpu_is_the_plain_pair():
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(20, 6, 4)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(20,)).astype(np.float32))
    out = K4.fm_interaction_train(emb)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, emb, g)
    assert torch.equal(got, K4.fm_interaction_bwd_plain(emb.detach(), g))
    # the entry point on CPU tensors trains through the plain version
    (again,) = torch.autograd.grad(fm_second_order(emb), emb, g)
    torch.testing.assert_close(again, got, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", [0, 3])
def test_fm_loss_and_grads_match_reference(step):
    rparams = RR.init(jax.random.PRNGKey(0), R_SMOKE)
    stream = RecsysStream(n_fields=R_SMOKE.n_fields, batch=128, seed=0, step=step)
    batch = stream.next()
    rl, rg = jax.value_and_grad(
        lambda p: RR.loss_fn(p, jax.tree.map(jnp.asarray, batch), R_SMOKE))(rparams)
    pparams = fm_params_from_arrays(jax.tree.map(np.asarray, rparams), SMOKE,
                                    torch_device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pl, pg = value_and_grad(lambda p, b: R.loss_fn(p, b, SMOKE), pparams, tb)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    for key in ("emb", "w1", "bias"):
        want, got = np.asarray(rg[key]), pg[key].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=key)
    assert np.abs(pg["emb"].numpy()).max() > 0
