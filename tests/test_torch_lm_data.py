"""The port's synthetic LM corpus (``repro_torch.data.lm``) against the
reference's (``repro.data.lm``): tokens and labels bitwise, in the eager
mode (every chain from one seed stream) and the lazy mode (each node's
chain from ``SeedSequence([seed, node])``), through ``lm_batches_for_dfl``
and ``lm_batches_for_cohort``; and the contracts of
``tests/test_determinism.py`` and ``tests/test_system.py`` on the port's
copy (deterministic batches, lazy shards independent of access order,
cohort slots streaming by global id)."""
import numpy as np
import pytest

from repro.data import lm as jlm
from repro_torch.data import lm


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("vocab,nodes,alpha,seed", [
    (97, 3, 0.7, 0), (512, 4, 0.5, 3), (151936, 2, 0.5, 0)])
def test_tokens_bitwise_reference(vocab, nodes, alpha, seed, lazy):
    kw = dict(vocab_size=vocab, num_nodes=nodes, noniid_alpha=alpha,
              seed=seed, lazy=lazy)
    got = lm.lm_batches_for_dfl(lm.SyntheticLM(**kw), tau1=2,
                                num_nodes=nodes, batch_per_node=2,
                                seq_len=16, round_idx=3)
    want = jlm.lm_batches_for_dfl(jlm.SyntheticLM(**kw), tau1=2,
                                  num_nodes=nodes, batch_per_node=2,
                                  seq_len=16, round_idx=3)
    for key in ("tokens", "labels"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["tokens"].shape == (2, nodes, 2, 16)
    assert int(got["tokens"].max()) < vocab
    np.testing.assert_array_equal(got["tokens"][..., 1:],
                                  got["labels"][..., :-1])


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_cohort_batches_bitwise_reference(lazy):
    ids = np.array([13, 2, 7, 0])
    kw = dict(vocab_size=64, num_nodes=16, seed=5, lazy=lazy)
    got = lm.lm_batches_for_cohort(lm.SyntheticLM(**kw), 3, ids, 2, 8, 4)
    want = jlm.lm_batches_for_cohort(jlm.SyntheticLM(**kw), 3, ids, 2, 8, 4)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    with pytest.raises(ValueError, match="1-D"):
        lm.lm_batches_for_cohort(lm.SyntheticLM(**kw), 1, ids[None], 1, 4, 0)


def test_batches_deterministic_and_lazy_order_free():
    corpus = lm.SyntheticLM(vocab_size=97, num_nodes=3, noniid_alpha=0.7)
    a = lm.lm_batches_for_dfl(corpus, 2, 3, 4, 16, 0)
    b = lm.lm_batches_for_dfl(corpus, 2, 3, 4, 16, 0)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    fwd = lm.SyntheticLM(vocab_size=32, num_nodes=64, seed=5, lazy=True)
    rev = lm.SyntheticLM(vocab_size=32, num_nodes=64, seed=5, lazy=True)
    for node in range(64):
        fwd.batch(node, 1, 4, 0)
    for node in reversed(range(64)):
        rev.batch(node, 1, 4, 0)
    for node in (0, 17, 63):
        np.testing.assert_array_equal(fwd.batch(node, 2, 8, 3)["tokens"],
                                      rev.batch(node, 2, 8, 3)["tokens"])
    # a cohort slot streams its global node's shard, whatever the slot
    c1 = lm.lm_batches_for_cohort(fwd, 1, np.array([5, 9]), 2, 8, 2)
    c2 = lm.lm_batches_for_cohort(rev, 1, np.array([9, 5]), 2, 8, 2)
    np.testing.assert_array_equal(c1["tokens"][:, 0], c2["tokens"][:, 1])
