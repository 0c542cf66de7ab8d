"""Multi-host as an EXERCISED capability (VERDICT round 2, item #6;
SURVEY.md section 4 'distributed tests without a cluster').

Spawns 2 real OS processes, each with 4 virtual CPU devices, joined by
jax.distributed.initialize over a localhost coordinator with gloo CPU
collectives standing in for the interconnect. The worker
(scripts/multihost_worker.py) renders over a global ("tile", "sample")
mesh spanning both processes -- the tile axis crosses the host boundary --
and asserts the gathered image equals the single-process render, then runs
one cross-process inverse-rendering train step (full-mesh gradient psum).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_render_matches_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "result.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # the workers size their own device count; don't inherit the suite's
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"

    with open(out) as f:
        result = json.load(f)
    assert result["process_count"] == 2
    assert result["global_devices"] == 8
    assert result["albedo_finite"]
    assert result["ok"], result
    assert result["max_abs_err"] < 2e-5


CLI_WORKER = os.path.join(ROOT, "scripts", "multihost_cli_worker.py")


def test_two_process_cli_render_matches_single(tmp_path):
    """The PRODUCT CLI under a 2-process mesh (the --multihost deployment
    shape): per-batch stats through the replicated gbuffer_progress
    reduction, the collective checkpoint gather outside the rank-0 guard,
    and the final cross-process resolve -- the exact paths that raised on
    non-addressable shards before the round-5 fix. Both processes must
    produce the same PNG as the single-process sharded run."""
    port = _free_port()
    outs = [str(tmp_path / f"r{i}.png") for i in range(2)]
    ck = str(tmp_path / "ck.npz")
    base = [
        "--scene", "cornell", "--width", "16", "--height", "16",
        "--max-samples", "3", "--min-samples", "2", "--seed", "5",
        "--max-bounces", "3", "--ray-chunk", "0", "--devices", "auto",
        "--checkpoint", ck, "--checkpoint-every", "2",
    ]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, CLI_WORKER, str(pid), "2", str(port)]
            + base + ["--out", outs[pid]],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    results = [p.communicate(timeout=540) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, f"CLI worker failed:\n{stderr[-3000:]}"
    assert os.path.exists(ck), "rank 0 never wrote the checkpoint"

    # single-process sharded reference (8 virtual devices, same seed)
    from isaklm_raytracer_tpu.cli.render import main as cli_main

    ref = str(tmp_path / "ref.png")
    assert cli_main(base[:-4] + ["--out", ref]) == 0  # drop ck args

    with open(outs[0], "rb") as a, open(outs[1], "rb") as b, \
            open(ref, "rb") as c:
        b0, b1, br = a.read(), b.read(), c.read()
    assert b0 == b1, "the two processes resolved different images"
    assert b0 == br, "multihost image differs from single-process"
