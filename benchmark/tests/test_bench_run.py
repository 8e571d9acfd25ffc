"""``run.py`` and the harness around the port: no card means no result;
no JAX and no ``bsmap_tpu`` is loaded, and the reference loads nothing of
the port; a run whose timed path is broken underneath comes out not
correct, and so does the control."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, tiny_cell


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wgbs_se100",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_py_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = _run_py(REPO)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert r.stdout.strip() == ""


def test_run_py_fails_in_a_bare_checkout(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    r = _run_py(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_imports_compared_by_top_level_name():
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {REPO!r}]; "
            "import compare, control, refalign, genome, reads, drain; "
            "ref = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'bsmap_tpu_torch', 'bsmap_tpu', 'jax', 'jaxlib', 'flax'}); "
            "import harness, port, bench_trace, spec, run; "
            "import bsmap_tpu_torch.cli, bsmap_tpu_torch.engine.pair_pipeline;"
            " print(ref, harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "[]"]
    import harness
    sys.modules["bsmap_tpu.params"] = sys.modules["os"]
    try:
        assert harness.forbidden_modules() == ["bsmap_tpu.params"]
    finally:
        del sys.modules["bsmap_tpu.params"]


def _run(cell, cache_root, seed=2**32 + 17):
    import harness
    return harness.run_cell(cell, seed, 0.5, False, device="cpu",
                            cache_root=cache_root)


def _drop_half(fmt_out: bytes) -> bytes:
    lines = bytes(fmt_out).splitlines(True)
    return b"".join(ln for i, ln in enumerate(lines)
                    if ln.startswith(b"@") or i % 2)


def _shift_pos(fmt_out: bytes) -> bytes:
    out = []
    for i, ln in enumerate(bytes(fmt_out).splitlines(True)):
        f = ln.split(b"\t")
        if not ln.startswith(b"@") and i % 7 == 0 and len(f) > 3:
            f[3] = b"%d" % (int(f[3]) + 1)
        out.append(b"\t".join(f))
    return b"".join(out)


@pytest.mark.parametrize("fault", [None, "half of the batch left out",
                                   "an answer altered where it is made"])
def test_se_run_correct_and_faults(tmp_path, cache_root, monkeypatch, fault):
    from bsmap_tpu_torch.engine.device_engine import DeviceEngine
    if fault:
        broken = _drop_half if fault.startswith("half") else _shift_pos
        orig = DeviceEngine.format_aligned_block
        monkeypatch.setattr(
            DeviceEngine, "format_aligned_block",
            lambda self, *a: broken(orig(self, *a)))
    res = _run(tiny_cell("wgbs_se100", str(tmp_path)), cache_root)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res["checks"])[-1] == "passes"
    assert res["metrics"]["reads_per_s"]["value"] > 0


def _pe_run(tmp_path, cache_root, monkeypatch, workload, fault):
    from bsmap_tpu_torch.engine.pair_device import PairDeviceEngine
    if fault:
        broken = _drop_half if fault.startswith("half") else _shift_pos
        orig = PairDeviceEngine.emit_block
        monkeypatch.setattr(
            PairDeviceEngine, "emit_block",
            lambda self, *a: tuple(broken(x) for x in orig(self, *a)))
    return _run(tiny_cell(workload, str(tmp_path), n=2500, sample=200),
                cache_root)


@pytest.mark.parametrize("fault", [None, "half of the batch left out"])
def test_pe_trim_run_correct_and_faults(tmp_path, cache_root, monkeypatch,
                                        fault):
    res = _pe_run(tmp_path, cache_root, monkeypatch, "wgbs_pe100_trim",
                  fault)
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", [None, "half of the batch left out",
                                   "an answer altered where it is made"])
def test_pe_plain_run_correct_and_faults(tmp_path, cache_root, monkeypatch,
                                         fault):
    res = _pe_run(tmp_path, cache_root, monkeypatch, "wgbs_pe100", fault)
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("workload", ["wgbs_se100", "wgbs_pe100_trim",
                                      "wgbs_pe100"])
def test_control_is_not_correct(tmp_path, cache_root, workload):
    import control
    import genome
    import harness
    import reads
    cell = tiny_cell(workload, str(tmp_path))
    cache = os.path.join(cache_root, harness.genome_key(cell.config))
    genome.ensure_genome(cell.config, cache)
    paths = reads.write_reads(cell.config, cell.traffic, cache,
                              str(tmp_path), procs=1)
    sample = harness.sample_indices(4000, 400, 5)
    assert control.control_bad(cell.config, cell.traffic, cache, paths,
                               sample, "cpu") > 0


@pytest.mark.gpu
def test_cell_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _run_py(REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
