"""Port parity: the elastic-restart helpers (``launch/mesh.
make_mesh_for_devices`` and ``launch/elastic``) against the JAX package's.

* ``make_mesh_for_devices``: equal to JAX's ``MeshLayout`` (shape,
  requested degree, ``degraded``) where JAX can build its mesh on this
  CPU (one device); elsewhere JAX's documented contract, with JAX's own
  error text where JAX raises before building a mesh: an explicit degree
  that does not divide the devices raises, ``allow_degrade`` halves it and
  records ``degraded``, the automatic degree is min(16, n) halved to a
  divisor.
* ``rebalance_batch``: JAX's rule (the global batch over the data axis),
  equal to JAX's on its one-device mesh, raising on a batch that does not
  split.
* ``elastic_resume``: a ``CheckpointManager`` checkpoint (params and an
  ``AdamState``) restores bit-equal, with its step, on ``device="cpu"``; a
  JAX checkpoint does too; no checkpoint gives ``(None, None, layout)``;
  without ``device`` on a host without a card it raises before reading.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.launch.elastic import rebalance_batch as jrebalance
from repro.launch.mesh import make_mesh_for_devices as jmake
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager
from repro_torch.launch.elastic import elastic_resume, rebalance_batch
from repro_torch.launch.mesh import MeshLayout, make_mesh_for_devices
from repro_torch.optim import AdamState


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("mp,degrade", [(0, False), (1, False), (1, True), (0, True)])
def test_one_device_layout_equals_jax(mp, degrade):
    mine = make_mesh_for_devices(1, mp, allow_degrade=degrade)
    theirs = jmake(1, mp, allow_degrade=degrade)
    assert (mine.shape, mine.requested_model, mine.degraded) == \
        (theirs.shape, theirs.requested_model, theirs.degraded)
    assert theirs.mesh.axis_names == ("data", "model")


@pytest.mark.parametrize("n,mp", [(6, 4), (8, 3), (12, 5), (0, 0), (-2, 1)])
def test_refusals_equal_jax_text(n, mp):
    """JAX raises these before it builds a mesh, so its text is at hand."""
    mine = _error(lambda: make_mesh_for_devices(n, mp))
    theirs = _error(lambda: jmake(n, mp))
    assert mine is not None and mine == theirs


@pytest.mark.parametrize("n,mp,degrade,want", [
    (8, 4, False, (2, 4, False)),
    (8, 3, True, (8, 1, True)),       # 3 -> 1, labeled
    (6, 4, True, (3, 2, True)),
    (12, 0, False, (1, 12, False)),   # auto: min(16, 12) divides
    (24, 0, False, (3, 8, False)),    # auto: 16 halved to 8
    (32, 0, False, (2, 16, False)),
    (7, 0, False, (1, 7, False)),     # auto: min(16, 7) divides
    (20, 0, False, (5, 4, False)),    # auto: 16 -> 8 -> 4
    (16, 16, True, (1, 16, False)),
])
def test_layout_follows_jax_contract(n, mp, degrade, want):
    lay = make_mesh_for_devices(n, mp, allow_degrade=degrade)
    assert (lay.data, lay.model, lay.degraded) == want
    assert lay.shape == want[:2] and lay.data * lay.model == n
    assert lay.requested_model == mp


def test_rebalance_batch_follows_jax():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    lay = make_mesh_for_devices(1)
    for gb in (1, 7, 256):
        assert rebalance_batch(gb, lay) == jrebalance(gb, jmesh) == gb
    assert rebalance_batch(256, make_mesh_for_devices(8, 4)) == 128
    assert rebalance_batch(256, MeshLayout(data=4, model=2, requested_model=0,
                                           degraded=False)) == 64
    with pytest.raises(ValueError, match="global batch 255 not divisible by "
                                         "data parallelism 2 after re-scale"):
        rebalance_batch(255, make_mesh_for_devices(8, 4))


def _state(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"layers": {"ffn": {"w1": {"w": t(2, 4, 4), "s_w": t(2, 1, 4),
                                        "s_a": t(2)}}},
              "embed": t(8, 4)}
    opt = AdamState(torch.tensor(3, dtype=torch.int32),
                    {k: v for k, v in params.items()}, {k: v for k, v in params.items()})
    return {"params": params, "opt": opt}


def test_elastic_resume_restores_bit_equal(tmp_path):
    saved = _state(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(5, saved)
    like = _state(1)
    state, step, layout = elastic_resume(like, mgr, model_parallel=1, device="cpu")
    assert step == 5 and layout.shape == (1, 1) and not layout.degraded
    got, want = manager._flatten(state), manager._flatten(saved)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert isinstance(state["opt"], AdamState)
    assert state["params"]["embed"].device.type == "cpu"
    # a degree the live devices cannot hold is halved, not refused
    _, _, lay = elastic_resume(like, mgr, model_parallel=4, device="cpu")
    assert lay.shape == (1, 1) and lay.degraded and lay.requested_model == 4


def test_elastic_resume_restores_a_jax_checkpoint(tmp_path):
    saved = _state(2)
    jstate = {"params": jax.tree.map(lambda a: jnp.asarray(a.numpy()), saved["params"])}
    JCkpt(str(tmp_path)).save(9, jstate)
    state, step, _ = elastic_resume({"params": _state(3)["params"]},
                                    CheckpointManager(str(tmp_path)), device="cpu")
    assert step == 9
    for k, v in manager._flatten(saved["params"]).items():
        np.testing.assert_array_equal(manager._flatten(state["params"])[k], v, err_msg=k)


def test_elastic_resume_without_a_checkpoint_or_a_card(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    state, step, layout = elastic_resume(_state(0), mgr, device="cpu")
    assert state is None and step is None and layout.shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            elastic_resume(_state(0), mgr)
