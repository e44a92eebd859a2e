"""The port's teacher driver's evaluation and dump against the JAX
driver's, end to end on the CPU (training:
tests/test_torch_cli_spatial_transformer.py, whose tree and JAX initial
state this file makes again).

The JAX driver's ``-e -d -b 1`` from a JAX-written checkpoint of
``Q2L(swin_nano_64, "all")``, and the port's ``-e -d --device cpu`` from
the same file, must give the same test mAP table (within 1e-6) and dump:
every video's (1, 256) float32 feature at atol 5e-5 (the Q2L float32
bound, tests/test_torch_q2l.py). ``--quant_eval``
runs the int8 twin for the test and dump: a dump close to the float one
(correlation > 0.99) but not equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cli_spatial_transformer import (  # noqa: E402
    COMMON,
    FRAMES,
    given_state,
    save_init,
    write_tree,
)

from computervision_codes_tpu.cli import spatial_transformer as jax_driver
from computervision_codes_tpu_torch.cli import spatial_transformer
from computervision_codes_tpu_torch.data.feature_store import FeatureStore

EVAL_BATCH = 1  # one frame a video
DUMP_ATOL, MAP_ABS = 5e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    split = write_tree(root, ())
    state = save_init([root + "/ckpt"], "")  # the best checkpoint
    evaluate = ["--data_dir", root, "-e", "-d", "-b", str(EVAL_BATCH),
                *COMMON, "--ckpt_root", root + "/ckpt"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "create_train_state", given_state(state))
        jax_result = jax_driver.main(evaluate + ["--feats_dir",
                                                 root + "/feats_jax"])
    port_result = spatial_transformer.main(
        evaluate + ["--feats_dir", root + "/feats_port", "--device", "cpu"])
    return {"root": root, "split": split, "jax": jax_result,
            "port": port_result, "evaluate": evaluate}


def _dump(root, side):
    return FeatureStore(f"{root}/{side}", "Q2L").load(1, "feats")


def test_eval_and_dump_from_jax_checkpoint_match_jax_driver(runs):
    root, split = runs["root"], runs["split"]
    got, want = _dump(root, "feats_port"), _dump(root, "feats_jax")
    assert set(got) == set(want) == {v[3:] for v in split.all_videos}
    for v in want:
        assert got[v].dtype == np.float32 and got[v].shape == (FRAMES, 256)
        np.testing.assert_allclose(got[v], want[v], atol=DUMP_ATOL,
                                   err_msg=v)
    got_map, want_map = runs["port"]["test_mAP"], runs["jax"]["test_mAP"]
    assert set(got_map) == set(want_map)
    for c, m in want_map.items():
        assert abs(got_map[c] - m) <= MAP_ABS, c


def test_quant_eval_runs_the_int8_twin(runs, tmp_path):
    root = runs["root"]
    result = spatial_transformer.main(
        runs["evaluate"] + ["--quant_eval", "--quant_min_dim", "128",
                            "--feats_dir", f"{tmp_path}/feats",
                            "--device", "cpu"])
    assert all(0.0 <= m <= 1.0 for m in result["test_mAP"].values())
    q8, float_dump = _dump(tmp_path, "feats"), _dump(root, "feats_port")
    assert set(q8) == set(float_dump)
    a = np.concatenate([q8[v].ravel() for v in q8])
    b = np.concatenate([float_dump[v].ravel() for v in q8])
    assert np.isfinite(a).all() and not np.array_equal(a, b)
    assert np.corrcoef(a, b)[0, 1] > 0.99
