"""Port vs JAX package on the CPU: the vocab-ring CE of ``train_sp``.

``models.model.ring_ce_sum`` under ``train_sp`` on a (1, R) ("data",
"model") mesh of R = 2 and 4 gloo ranks (``launch.ranks.sp_ring_ce``):
each rank streams its columns of the final hidden state through the
vocab blocks that go round the model ring, the tied head's (qwen2-0.5b:
rank s starts from its rows of the (V, D) table) and the untied head's
(starcoder2-3b: its (D/R, V) rows re-blocked to (D, V/R) by one
all-to-all).  The sum over the model axis, each rank's columns' dx and
the head's gradient summed over the ranks are held against the
reference's dense CE (``_ce_sum_dense`` of ``lm_logits``) and
``jax.grad`` of it, with per-example weights, at
``tests/sharded/ring_ce_check.py``'s bars: the loss within 1e-4, every
gradient within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jget
from repro.models import model as JM
from repro_torch import tree, weights
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import ranks

LOSS_TOL, GRAD_TOL = 1e-4, 1e-3          # ring_ce_check.py
B, S = 4, 16
ARCHS = ["qwen2-0.5b", "starcoder2-3b"]  # tied, untied


def _case(name, seed):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jparams = JM.init_model(jc, jax.random.PRNGKey(0))
    params = tree.map(lambda x: x.numpy(), weights.from_jax(
        tc, jax.tree.map(np.asarray, jparams), device="cpu"))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int64)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    return jc, jparams, (tc, params, x, labels, w)


def _reference(jc, jparams, x, labels, w):
    tied = jc.tie_embeddings
    head = jparams["embed"]["table"] if tied else jparams["lm_head"]["w"]

    def f(x, head):
        p = dict(jparams)
        if tied:
            p["embed"] = dict(p["embed"], table=head)
        else:
            p["lm_head"] = dict(p["lm_head"], w=head)
        return JM._ce_sum_dense(JM.lm_logits(jc, p, x), jnp.asarray(labels),
                                jnp.asarray(w))

    loss, (dx, dh) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), head)
    return float(loss), np.asarray(dx), np.asarray(dh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for T in (2, 4):
        cases = [_case(name, seed=T + i) for i, name in enumerate(ARCHS)]
        pg = tmp_path_factory.mktemp(f"spr{T}") / "pg"
        out[T] = (cases, ranks.spawn(ranks.sp_ring_ce, T,
                                     [c[2] for c in cases],
                                     init_method=f"file://{pg}"))
    return out


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("name", ARCHS)
def test_ring_ce_matches_reference_dense_ce(runs, T, name):
    cases, per_rank = runs[T]
    i = ARCHS.index(name)
    jc, jparams, (tc, _, x, labels, w) = cases[i]
    assert tc.tie_embeddings == (name == "qwen2-0.5b")
    want_loss, want_dx, want_dh = _reference(jc, jparams, x, labels, w)
    n = S // T
    dh = sum(rank[i][2] for rank in per_rank)
    for s, rank in enumerate(per_rank):
        loss, dx, _ = rank[i]
        assert abs(loss - want_loss) < LOSS_TOL, (name, T, s, loss,
                                                  want_loss)
        gap = float(np.abs(dx - want_dx[:, s * n:(s + 1) * n]).max())
        assert gap < GRAD_TOL, (name, T, s, "dx", gap)
    gap = float(np.abs(dh - want_dh).max())
    assert gap < GRAD_TOL, (name, T, "head", gap)
    assert float(np.abs(want_dh).max()) > 10 * GRAD_TOL   # the bar binds
