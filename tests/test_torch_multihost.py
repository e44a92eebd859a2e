"""The port's multi-host input sharding, sharded prefetch and mesh session.

* ``shard_videos`` and ``local_batch_size`` against the JAX package's, on
  the same lists and counts: the same partitions and the same refusals.
* At 2 and 4 gloo ranks (``tests/torch_parallel_workers.py``: torch only,
  one thread a rank, a spawned group per world size):
  ``prefetch_to_device(sharding=batch_sharding(mesh))`` hands each rank its
  slice of every batch, whose concatenation over the ranks is the batch,
  exactly; ``form_global_batch`` puts the rank's leaves on its device,
  their concatenation the global batch; ``InferenceSession.create(mesh=
  ...)``, bf16 and int8, returns on every rank the meshless session's
  probabilities for the whole batch (held to the JAX session by
  tests/test_torch_serving.py) to 1e-6 (each rank's clips run the
  ordinary model at a smaller batch), refuses a batch that does not
  divide, and is not exportable.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from computervision_codes_tpu.data import multihost as jax_multihost
from computervision_codes_tpu_torch.data.multihost import (
    local_batch_size,
    shard_videos,
)
from computervision_codes_tpu_torch.serving import InferenceSession

VIDEOS = [f"VID{i:02d}" for i in range(1, 21)]
SESSION_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("counted", [False, True])
def test_shard_videos_matches_jax(n, counted):
    rng = np.random.default_rng(n)
    counts = ({v: int(rng.integers(100, 3000)) for v in VIDEOS}
              if counted else None)
    shards = [shard_videos(VIDEOS, h, n, counts) for h in range(n)]
    assert shards == [jax_multihost.shard_videos(VIDEOS, h, n, counts)
                      for h in range(n)]
    assert sorted(v for s in shards for v in s) == sorted(VIDEOS)


def test_local_batch_size_and_refusals_match_jax():
    for g, n in ((32, 4), (12, 3), (8, 1)):
        assert local_batch_size(g, 0, n) == \
            jax_multihost.local_batch_size(g, 0, n)
    for fn in (local_batch_size, jax_multihost.local_batch_size):
        with pytest.raises(ValueError, match="not divisible"):
            fn(30, 0, 4)
    for fn in (shard_videos, jax_multihost.shard_videos):
        with pytest.raises(ValueError, match="out of range"):
            fn(VIDEOS, 4, 4)
        with pytest.raises(ValueError, match="missing 1"):
            fn(VIDEOS, 0, 2, {v: 1 for v in VIDEOS[1:]})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    return {"batch_x": rng.standard_normal((8, 4, 3)).astype(np.float32),
            "clips": rng.integers(0, 256, (4, 2, 32, 32, 3), np.uint8),
            "servable_dir": str(tmp_path_factory.mktemp("servable"))}


@pytest.fixture(scope="module", params=[2, 4])
def group(request, inputs, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"multihost{n}")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    return n, workers.spawn(str(d), workers.MULTIHOST, n)


def _result(group, case):
    n, out = group
    res = [out[r][case] for r in range(n)]
    for r in res:
        assert "error" not in r, r.get("error")
    return n, res


def test_sharded_prefetch_and_global_batch(group, inputs):
    n, res = _result(group, "prefetch")
    x = inputs["batch_x"]
    step = len(x) // n
    for rank, r in enumerate(res):
        assert len(r["prefetch"]) == 3
        for i, b in enumerate(r["prefetch"]):
            np.testing.assert_array_equal(b["x"], x + i)
        np.testing.assert_array_equal(r["formed"], x)
        np.testing.assert_array_equal(r["formed_local"],
                                      x[rank * step:(rank + 1) * step])


_MESHLESS = {}


def _meshless(clips, q):
    if q not in _MESHLESS:
        _MESHLESS[q] = InferenceSession.create(
            batch=4, clip_len=2, height=32, width=32, quantize=q,
            device="cpu").predict(clips)
    return _MESHLESS[q]


def test_mesh_session_is_the_meshless_session(group, inputs):
    n, res = _result(group, "session")
    for q in (False, True):
        want = _meshless(inputs["clips"], q)
        for r in res:
            got = r[f"q{q}"]
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape
                np.testing.assert_allclose(got[k], want[k],
                                           atol=SESSION_ATOL, err_msg=k)
            assert "not exportable" in r[f"export{q}"]
    for r in res:
        assert "must divide the mesh data axis" in r["indivisible"]
