"""The port's utilities (gdslam_tpu_torch.utils.telemetry, .viewer), as
tests/test_aux.py holds the JAX package's: the JSONL log, the stage timer,
the profiler scope, the frame and map renders, and their PNG output through
the port's own io/png.py. The port only: nothing here runs JAX.
"""

import json
import os
import types

import numpy as np
import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.frontend.frame import Frame
from gdslam_tpu_torch.io import png
from gdslam_tpu_torch.system.tracking import TrackState
from gdslam_tpu_torch.utils import telemetry, viewer

torch.set_num_threads(1)


def test_jsonl_log(tmp_path):
    p = str(tmp_path / "m.jsonl")
    log = telemetry.MetricsLogger(p)
    log.log(frame=0, state="OK", inliers=123)
    log.log(frame=1, state="OK", inliers=120)
    log.close()
    lines = [json.loads(line) for line in open(p)]
    assert len(lines) == 2 and lines[1]["inliers"] == 120 and "t_wall" in lines[0]
    assert log.last["frame"] == 1


def test_stage_timer_and_frame_metrics():
    t = telemetry.StageTimer()
    for _ in range(2):
        with t("x"):
            pass
    s = t.summary()
    assert set(s) == {"x"} and s["x"]["total_s"] >= 0 and t.counts["x"] == 2
    arena = ma.new_arena(kmax=4, pmax=32, n_features=8, device="cpu")
    tracker = types.SimpleNamespace(frame_id=7, state=TrackState.OK, n_inliers=55, arena=arena,
                                    ref_kf=0)
    assert telemetry.frame_metrics(tracker) == dict(frame=7, state="OK", inliers=55, n_kf=0,
                                                    n_pt=0, ref_kf=0)


def test_profile_writes_a_trace(tmp_path):
    """torch.profiler over a scope: a Chrome trace with the scope's ops;
    no trace directory, no profiler."""
    with telemetry.profile(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with telemetry.profile(None):
        pass
    assert sorted(os.listdir(tmp_path)) == ["prof"]


def test_draw_frame_and_map_to_png(tmp_path):
    r = np.random.default_rng(0)
    H, W = 48, 64
    n = 10
    frame = Frame(uv=torch.from_numpy(r.uniform(5, 40, (n, 2)).astype(np.float32)),
                  uv_raw=torch.zeros(n, 2), ur=-torch.ones(n), depth=torch.zeros(n),
                  level=torch.zeros(n, dtype=torch.int32), angle=torch.zeros(n),
                  response=torch.ones(n), desc=torch.zeros(n, 32, dtype=torch.uint8),
                  valid=torch.ones(n, dtype=torch.bool))
    img = viewer.draw_frame(torch.full((H, W), 100.0), frame)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert (img[..., 1] == 255).any()                # keypoints drawn
    arena = ma.new_arena(kmax=4, pmax=32, n_features=8, device="cpu")
    arena = arena._replace(
        pt_pos=arena.pt_pos.index_copy(0, torch.arange(9),
                                       torch.from_numpy(r.uniform(-1, 1, (9, 3))
                                                        .astype(np.float32))),
        pt_valid=arena.pt_valid.index_fill(0, torch.arange(9), True),
        kf_valid=arena.kf_valid.index_fill(0, torch.arange(2), True),
        covis=torch.tensor([[0, 150, 0, 0], [150, 0, 0, 0], [0] * 4, [0] * 4],
                           dtype=torch.int32))
    m = viewer.draw_map(arena, size=64)
    assert m.shape == (64, 64, 3) and m.sum() > 0
    for name, a in (("frame.png", img), ("map.png", m)):
        viewer.save_png(a, str(tmp_path / name))
        assert np.array_equal(png.read(tmp_path / name), a)
