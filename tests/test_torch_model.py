"""The port's CNN, parameter conversion, data and topology against the JAX
reference.

Conversion and the copied numpy modules are bitwise. Logits and losses are
held to rtol 1e-5: the two frameworks order the conv and matmul reductions
differently, so model-level parity is never bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopology
from repro.data import images as jimages
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.data import images
from repro_torch.models import cnn

FLAVORS = ("mnist", "cifar")


def _numpy_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("flavor", FLAVORS)
def test_params_from_jax_round_trip(flavor):
    ref = jcnn.init_cnn(jax.random.key(3), flavor)
    stacked = {k: np.stack([np.asarray(v)] * 3) for k, v in ref.items()}
    for tree in (_numpy_tree(ref), stacked):
        got = params_from_jax(tree, device="cpu")
        assert set(got) == set(tree)
        for k, v in tree.items():
            assert got[k].dtype == torch.float32 and got[k].is_contiguous()
            assert np.array_equal(got[k].numpy().view(np.uint32),
                                  v.view(np.uint32))
    bf = {"w": np.asarray(jnp.asarray(stacked["c1"]).astype(jnp.bfloat16))}
    got = params_from_jax(bf, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          bf["w"].view(np.uint16))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_cnn_logits_and_loss_match_reference(flavor):
    ref = jcnn.init_cnn(jax.random.key(1), flavor)
    params = params_from_jax(_numpy_tree(ref), device="cpu")
    data = images.SyntheticImages(flavor=flavor, train_size=8, test_size=1,
                                  seed=2)
    x, y = data.train_x, data.train_y
    want = np.asarray(jcnn.cnn_logits(ref, jnp.asarray(x), flavor))
    got = cnn.cnn_logits(params, torch.from_numpy(x), flavor)
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    want_loss = float(jcnn.cnn_loss(ref, (jnp.asarray(x), jnp.asarray(y)),
                                    flavor))
    got_loss = float(cnn.cnn_loss(params, (torch.from_numpy(x),
                                           torch.from_numpy(y)), flavor))
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    want_acc = float(jcnn.cnn_accuracy(ref, jnp.asarray(x), jnp.asarray(y),
                                       flavor))
    assert float(cnn.cnn_accuracy(params, torch.from_numpy(x),
                                  torch.from_numpy(y), flavor)) == want_acc


@pytest.mark.parametrize("flavor", FLAVORS)
def test_init_cnn_layout_and_scale(flavor):
    ref = jcnn.init_cnn(jax.random.key(0), flavor)
    got = cnn.init_cnn(torch.Generator().manual_seed(0), flavor, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert sum(v.numel() for v in got.values()) == \
        {"mnist": 20490, "cifar": 576778}[flavor]
    for k, v in got.items():
        if v.dim() == 1:
            assert not v.any()
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            assert float(v.std()) == pytest.approx(fan_in ** -0.5, rel=0.2)
    again = cnn.init_cnn(torch.Generator().manual_seed(0), flavor,
                         device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_data_is_byte_identical(flavor):
    ours = images.SyntheticImages(flavor=flavor, train_size=64, test_size=8,
                                  seed=7)
    ref = jimages.SyntheticImages(flavor=flavor, train_size=64, test_size=8,
                                  seed=7)
    for a in ("train_x", "train_y", "test_x", "test_y"):
        assert np.array_equal(getattr(ours, a), getattr(ref, a))
    for scheme in ("dirichlet", "label_shard", "iid"):
        for p, q in zip(ours.partition(4, scheme), ref.partition(4, scheme)):
            assert np.array_equal(p, q)
    parts = ours.partition(4)
    xs, ys = images.image_batches_for_dfl(ours, parts, 3, 5, round_idx=2)
    rx, ry = jimages.image_batches_for_dfl(ref, parts, 3, 5, round_idx=2)
    assert xs.shape == (3, 4, 5) + ours.shape and ys.shape == (3, 4, 5)
    assert xs.tobytes() == rx.tobytes() and ys.tobytes() == ry.tobytes()


def test_topology_copy_matches_reference():
    for make in (lambda m: m.ring(10), lambda m: m.paper_quasi_ring(),
                 lambda m: m.fully_connected(4), lambda m: m.torus(3, 4),
                 lambda m: m.disconnected(3)):
        ours, ref = make(topology), make(jtopology)
        assert np.array_equal(ours.mixing, ref.mixing)
        assert ours.shifts() == ref.shifts()
        assert ours.edges() == ref.edges()
        assert ours.is_shift_structured() == ref.is_shift_structured()
        assert ours.zeta == ref.zeta
