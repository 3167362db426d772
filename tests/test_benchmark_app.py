"""Benchmark app: resumable reference renders (kill mid-ref, resume, get a
bit-identical image) and the --platform cpu escape hatch.

Reference contract: the OptiX app renders its ground-truth comparisons in one
uninterruptible progressive session (optixPathTracer.cpp render loop); here
long references checkpoint per chunk so an interrupted run resumes.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "spcbpt_tpu.apps.benchmark",
         "--platform", "cpu", "--scene", "cornell", "--dim", "64x64",
         "--ref-alg", "pt", "--spp", "1", "--algs", "pt"] + args,
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_ref_resume_bit_exact(tmp_path):
    ref_a = str(tmp_path / "ref_a.npz")
    ref_b = str(tmp_path / "ref_b.npz")
    out_a = str(tmp_path / "a.json")
    out_b = str(tmp_path / "b.json")

    # uninterrupted run
    r = _run(["--ref-spp", "64", "--ref-chunk", "8",
              "--ref-npz", ref_a, "--json", out_a])
    assert r.returncode == 0, r.stderr[-2000:]
    assert not os.path.exists(ref_a + ".partial.npz")

    # interrupted run: kill once the partial shows >= 16 spp accumulated
    proc = subprocess.Popen(
        [sys.executable, "-m", "spcbpt_tpu.apps.benchmark",
         "--platform", "cpu", "--scene", "cornell", "--dim", "64x64",
         "--ref-alg", "pt", "--spp", "1", "--algs", "pt",
         "--ref-spp", "64", "--ref-chunk", "8",
         "--ref-npz", ref_b, "--json", out_b],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    partial = ref_b + ".partial.npz"
    deadline = time.time() + 300
    killed = False
    while time.time() < deadline and proc.poll() is None:
        if os.path.exists(partial):
            try:
                done = int(np.load(partial)["spp_done"])
            except Exception:  # mid-write
                done = 0
            if done >= 16:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
        time.sleep(0.05)
    proc.wait(timeout=60)
    assert killed, "run finished before it could be interrupted"
    assert os.path.exists(partial), "partial checkpoint must survive the kill"

    # resumed run completes and matches the uninterrupted reference exactly
    r = _run(["--ref-spp", "64", "--ref-chunk", "8",
              "--ref-npz", ref_b, "--json", out_b])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[ref] resumed" in r.stdout
    assert not os.path.exists(partial), "partial must be cleaned up"
    a = np.load(ref_a)["img"]
    b = np.load(ref_b)["img"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    res = json.load(open(out_b))
    assert res["algs"]["pt"]["relmse"] < 10.0  # sane, 1-spp vs 64-spp ref


def test_mismatched_chunk_restarts(tmp_path):
    """A partial written with a different --ref-chunk is ignored (seeds are
    chunk-offset-based, so mixing chunk sizes would double-count samples)."""
    ref = str(tmp_path / "ref.npz")
    out = str(tmp_path / "o.json")
    r = _run(["--ref-spp", "16", "--ref-chunk", "8",
              "--ref-npz", ref, "--json", out])
    assert r.returncode == 0, r.stderr[-2000:]
    img16 = np.load(ref)["img"]

    # forge a partial with a mismatched chunk size; rerun must ignore it
    os.remove(ref)
    np.savez_compressed(ref + ".partial.npz",
                        acc=np.zeros_like(img16, dtype=np.float32),
                        cnt=np.zeros(img16.shape[0], dtype=np.float32),
                        spp_done=8, chunk=4)
    r = _run(["--ref-spp", "16", "--ref-chunk", "8",
              "--ref-npz", ref, "--json", out])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[ref] resumed" not in r.stdout
    np.testing.assert_allclose(np.load(ref)["img"], img16, rtol=0, atol=1e-6)
