"""The fused LM loss and cross entropy, port vs reference, on the CPU.

Float32 inputs from a seed go through ``layers.lm_loss_fused`` and
``layers.cross_entropy`` of both packages: the loss within 1e-6 relative
and its gradients within atol 1e-7 + rtol 1e-5 (the two frameworks'
``logsumexp`` and summation orders differ in the last bits).  Lengths are
chosen so that the chunk rule shows: 699 = 3 * 233 gives chunks of 233,
2047 = 23 * 89 chunks of 89 (as qwen2-moe's S = 2048 does), 1024 two
chunks of 512.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as RL  # noqa: E402

from repro_torch.models import layers as PL  # noqa: E402


def _inputs(b, s, d, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    return x, w, labels


@pytest.mark.parametrize("b,s,d,v", [(2, 699, 32, 257), (1, 2047, 16, 100), (2, 1024, 8, 64),
                                     (3, 5, 8, 11)])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_lm_loss_fused_matches_reference(b, s, d, v, z_loss):
    x, w, labels = _inputs(b, s, d, v, seed=s + v)

    def rloss(x, w):
        return RL.lm_loss_fused(x, w, jnp.asarray(labels), z_loss)

    rl, (rgx, rgw) = jax.value_and_grad(rloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    pl = PL.lm_loss_fused(xt, wt, torch.from_numpy(labels), z_loss)
    pgx, pgw = torch.autograd.grad(pl, (xt, wt))
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-6)
    np.testing.assert_allclose(pgx.numpy(), np.asarray(rgx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pgw.numpy(), np.asarray(rgw), rtol=1e-5, atol=1e-7)
    # without autograd recording, the same value
    with torch.no_grad():
        assert float(PL.lm_loss_fused(xt, wt, torch.from_numpy(labels), z_loss)) == float(pl)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_lm_loss_fused_equals_unchunked_cross_entropy(z_loss):
    x, w, labels = _inputs(2, 699, 16, 50, seed=4)
    xt, wt, lt = (torch.from_numpy(a) for a in (x, w, labels))
    fused = PL.lm_loss_fused(xt, wt, lt, z_loss)
    whole = PL.cross_entropy(xt @ wt, lt, z_loss)
    np.testing.assert_allclose(float(fused), float(whole), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 9, 30), (2, 3, 7, 100)])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(shape, z_loss):
    rng = np.random.default_rng(len(shape))
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    rl, rg = jax.value_and_grad(lambda z: RL.cross_entropy(z, jnp.asarray(labels), z_loss))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    pl = PL.cross_entropy(lt, torch.from_numpy(labels), z_loss)
    (pg,) = torch.autograd.grad(pl, lt)
    np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-8)


def test_lm_loss_fused_bf16_hidden_states():
    """bf16 hidden states against float32 weights, as the LMs call it: the
    weights are cast to bf16 for the product, logits taken in float32;
    within 1e-3 relative of the reference (the bf16 products round in
    each package's own order)."""
    x, w, labels = _inputs(2, 129, 32, 64, seed=9)
    rl = RL.lm_loss_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(labels), 1e-4)
    pl = PL.lm_loss_fused(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                          torch.from_numpy(labels), 1e-4)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-3)
