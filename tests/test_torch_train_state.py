"""The train-state checkpoint pair (``io/checkpoint.py::save_train_state``
/ ``load_train_state``), held to ``dvren_tpu``'s contract.

A nested structure of dicts, lists and tuples of tensors round-trips in
the JAX format's shape (``kind="train_state"``, a JSON header, ``leaf_i``
arrays); a structure, leaf-count or shape mismatch raises ``DvrenError``
before anything is assigned (``tests/test_round2_fixes.py``'s checks);
restored tensors land on the device and dtype of the ``like`` leaves; an
Adam fit resumed from a checkpoint after 3 of 6 steps ends bit-equal to 6
uninterrupted steps. A JAX train-state file does not load here.
"""

import json

import numpy as np
import pytest
import torch

from dvren_tpu.io import checkpoint as j_ckpt
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.io import checkpoint as p_ckpt
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"sigma": torch.randn(4, 3, generator=g),
                       "color": torch.randn(4, 3, 3, generator=g)},
            "optim": {"state": {0: {"step": torch.tensor(3.0),
                                    "exp_avg": torch.randn(5, generator=g)}},
                      "param_groups": [{"lr": 0.05, "betas": (0.9, 0.999),
                                        "params": [0], "foreach": None}]},
            "history": [torch.arange(3, dtype=torch.int32),
                        (torch.ones(2, dtype=torch.float64),)]}


def test_round_trip(tmp_path):
    path = tmp_path / "s.npz"
    state = _state()
    p_ckpt.save_train_state(path, state, {"step": 3})
    with np.load(path) as data:
        meta = json.loads(str(data["header"]))
        assert meta["kind"] == "train_state" and meta["format"] == 1
        assert sorted(data.files) == ["header"] + [f"leaf_{i}"
                                                   for i in range(6)]
    like = _state()
    for t in (like["params"]["sigma"], like["optim"]["state"][0]["exp_avg"]):
        t.zero_()
    out, header = p_ckpt.load_train_state(path, like)
    assert header == {"step": 3}
    assert out["optim"]["param_groups"] == state["optim"]["param_groups"]
    assert isinstance(out["history"][1], tuple)
    flat_a, flat_b = [], []
    p_ckpt._flatten(out, flat_a)
    p_ckpt._flatten(state, flat_b)
    assert len(flat_a) == 6
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_leaves_take_the_like_dtype_and_device(tmp_path):
    path = tmp_path / "s.npz"
    p_ckpt.save_train_state(path, {"w": torch.arange(4.0)}, {})
    like = {"w": torch.zeros(4, dtype=torch.float64)}
    out, _ = p_ckpt.load_train_state(path, like)
    assert out["w"].dtype == torch.float64 and out["w"].device == like[
        "w"].device
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(4.0))


@pytest.mark.parametrize("like, match", [
    ({"a": torch.zeros(3), "b": [torch.zeros(2)]}, "structure"),
    ({"a": torch.zeros(3), "c": (torch.zeros(2),)}, "structure"),
    ({"a": torch.zeros(4), "b": (torch.zeros(2),)}, "shape"),
])
def test_mismatch_raises(tmp_path, like, match):
    """As ``tests/test_round2_fixes.py``: a different structure of the
    same leaf count, or a leaf of another shape, raises."""
    path = tmp_path / "s.npz"
    p_ckpt.save_train_state(path, {"a": torch.zeros(3),
                                   "b": (torch.zeros(2),)}, {})
    with pytest.raises(P.DvrenError, match=match):
        p_ckpt.load_train_state(path, like)


def test_leaf_count_mismatch_raises(tmp_path):
    path = tmp_path / "s.npz"
    p_ckpt.save_train_state(path, {"a": [torch.zeros(3), torch.zeros(2)]}, {})
    # the count check stands behind the structure check: a file whose
    # leaves were cut keeps its structure
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "leaf_1"}
    np.savez(tmp_path / "cut.npz", **arrays)
    with pytest.raises(P.DvrenError, match="leaf count"):
        p_ckpt.load_train_state(tmp_path / "cut.npz",
                                {"a": [torch.zeros(3), torch.zeros(2)]})


def test_other_kinds_and_jax_files_refused(tmp_path):
    plan, field = scene()
    p_ckpt.save_dense_grid(tmp_path / "g.npz", port_field(field))
    with pytest.raises(P.DvrenError, match="kind"):
        p_ckpt.load_train_state(tmp_path / "g.npz", {})
    j_ckpt.save_train_state(tmp_path / "j.npz",
                            {"w": np.zeros(3, np.float32)}, {})
    with pytest.raises(P.DvrenError, match="structure"):
        p_ckpt.load_train_state(tmp_path / "j.npz", {"w": torch.zeros(3)})


def _adam_steps(field, opt, pplan, sched, target, n):
    for _ in range(n):
        opt.zero_grad()
        img = p_tiled.render_tiled(pplan, field, sched).image
        torch.mean((img - target) ** 2).backward()
        opt.step()


def test_resumed_adam_equals_uninterrupted(tmp_path):
    plan, jfield = scene()
    pplan = port_plan(plan)
    teacher = port_field(jfield)
    sched = p_tiled.build_tiled_schedule(pplan, teacher).to("cpu")
    with torch.no_grad():
        target = p_tiled.render_tiled(pplan, teacher, sched).image

    def student():
        f = port_field(jfield)
        with torch.no_grad():
            f.sigma.fill_(0.5)
            f.color.fill_(0.5)
        return f, torch.optim.Adam(f.parameters(), lr=5e-2)

    straight, opt = student()
    _adam_steps(straight, opt, pplan, sched, target, 6)

    first, opt = student()
    _adam_steps(first, opt, pplan, sched, target, 3)
    path = tmp_path / "resume.npz"
    p_ckpt.save_train_state(path, {"params": first.state_dict(),
                                   "optim": opt.state_dict()}, {"step": 3})
    resumed, opt2 = student()
    state, header = p_ckpt.load_train_state(
        path, {"params": resumed.state_dict(), "optim": opt2.state_dict()})
    assert header == {"step": 3}
    resumed.load_state_dict(state["params"])
    opt2.load_state_dict(state["optim"])
    _adam_steps(resumed, opt2, pplan, sched, target, 3)
    assert not torch.equal(first.sigma, straight.sigma)
    assert torch.equal(resumed.sigma, straight.sigma)
    assert torch.equal(resumed.color, straight.color)
