"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same on-disk format, so a
checkpoint written by either package restores in the other bit for bit,
bf16 leaves included (the reference's ``np.savez`` writes an
``ml_dtypes.bfloat16`` array as raw ``V2``; the port writes and reads its
bf16 leaves the same way). Also the reference's contracts on the port's
copy: atomic writes, the newest intact checkpoint restored past a torn
one, a wrong template raising ``ShapeMismatchError``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.checkpoint.io import _key_of
from repro.configs import REGISTRY as JREGISTRY
from repro.models import init_params as jinit_params
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.io import ShapeMismatchError, available_steps
from repro_torch.convert import params_from_jax

ARCHS = ("qwen3-1.7b", "jamba-1.5-large-398b")


def _bits(t):
    t = torch.as_tensor(t)
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype))


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_port(arch, tmp_path):
    """A reduced model's bf16 / f32 tree (Jamba's mamba leaves are f32)
    saved by the reference restores in the port, bitwise, into the port's
    flat path-keyed dict."""
    jp, _ = jinit_params(JREGISTRY[arch].reduced, jax.random.key(0))
    jsave(str(tmp_path), 7, jp, {"loss": 1.5})
    template = {k: torch.zeros_like(v) for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu").items()}
    restored, step = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and list(restored) == list(template)
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    dtypes = set()
    for name, t in restored.items():
        assert t.dtype == flat[name].dtype
        dtypes.add(t.dtype)
        assert torch.equal(_bits(t), _bits(flat[name])), name
    assert torch.bfloat16 in dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(arch, tmp_path):
    jp, _ = jinit_params(JREGISTRY[arch].reduced, jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    params = {k: v + 0.5 for k, v in params.items()}   # not the template
    save_checkpoint(str(tmp_path), 3, params, {"loss": 2.0})
    restored, step = jrestore(str(tmp_path), jp)
    assert step == 3
    want = dict((_key_of(path), leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        name = _key_of(path)
        got = jnp.asarray(leaf)
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(_jax_bits(got),
                                      _bits(params[name]).numpy())


def test_bf16_roundtrip_and_nested_tree(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) * 1.37,
            "b": torch.linspace(0, 1, 4), "blocks": [{"x": torch.ones(2)}]}
    save_checkpoint(str(tmp_path), 3, tree, {"loss": 1.0})
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(_bits(restored["w"]), _bits(tree["w"]))
    assert torch.equal(restored["blocks"][0]["x"], tree["blocks"][0]["x"])
    with np.load(os.path.join(tmp_path, "ckpt_00000003.npz")) as data:
        assert set(data.files) == {"w", "b", "blocks/0/x"}
        assert data["w"].dtype.kind == "V" and data["w"].dtype.itemsize == 2


def test_newest_intact_checkpoint_and_shape_mismatch(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(4.0)}
    for step in (1, 2, 3):
        save_checkpoint(d, step, {"w": tree["w"] * step})
    assert available_steps(d) == [1, 2, 3] and latest_step(d) == 3
    with open(os.path.join(d, "ckpt_00000003.npz"), "r+b") as f:
        f.truncate(10)                        # a torn newest checkpoint
    restored, step = restore_checkpoint(d, tree)
    assert step == 2 and torch.equal(restored["w"], tree["w"] * 2)
    with pytest.raises(Exception):
        restore_checkpoint(d, tree, step=3)   # an explicit step is trusted
    with pytest.raises(ShapeMismatchError):
        restore_checkpoint(d, {"w": torch.zeros(5)})
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), tree)
