"""One run of one cell: the inputs (made once a checkout), the port's
set-up, the measured window (or, with ``trace``, one traced pass and the
layers timed alone), the readings, and the check of the timed output
against the plain reference."""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bsmap_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _io_write_bytes() -> int:
    """Bytes this process and its waited-for children sent to storage."""
    own = 0
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("write_bytes:"):
                own = int(line.split()[1])
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_oublock * 512
    return own + kids


def _tree_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _peak_rss_bytes() -> int:
    """The process's peak resident set (getrusage's ru_maxrss, the kernel's
    VmHWM), in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def genome_key(cfg: dict) -> str:
    """The cache directory's name: configurations with one genome (and
    so one packed genome and one index) share it.  It takes in the
    configuration's ``genome_features`` file where it names one."""
    import hashlib
    from spec import code_key
    g = [cfg["genome"]] + code_key(cfg, ["genome_features"])
    g = json.dumps(g[0] if len(g) == 1 else g, sort_keys=True).encode()
    return "genome_" + hashlib.sha1(g).hexdigest()[:12]


def reads_key(cell) -> str:
    """The name of the cell's read directory in the genome's cache: it
    takes in the configuration's ``library_script`` where it names one."""
    import hashlib
    from spec import code_key
    cfg = cell.config
    key = [cfg["layout"], cfg["read_len"], cfg["library"], cell.traffic]
    key += code_key(cfg, ["library_script"])
    return "reads_" + hashlib.sha1(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:12]


def ensure_reads(cell, cache_dir: str) -> list[str]:
    """The cell's pass file(s), made once into the genome's cache
    directory by ``reads.py`` or the configuration's ``library_script``:
    they follow from the configuration and the mix, not from the seed."""
    import shutil
    from spec import module_file
    cfg = cell.config
    script = (module_file(cfg, "library_script")
              or os.path.join(HERE, "reads.py"))
    d = os.path.join(cache_dir, reads_key(cell))
    paths = [os.path.join(d, "r1.fq")]
    if cfg["layout"] == "pe":
        paths.append(os.path.join(d, "r2.fq"))
    if not os.path.exists(os.path.join(d, "done")):
        part = d + ".part"
        shutil.rmtree(part, ignore_errors=True)
        os.makedirs(part)
        _child([script, "--config", cell.config_file,
                "--traffic", cell.traffic_file, "--cache", cache_dir,
                "--out", part])
        open(os.path.join(part, "done"), "w").close()
        shutil.rmtree(d, ignore_errors=True)
        os.rename(part, d)
    return paths


def sample_indices(n: int, k: int, seed: int) -> np.ndarray:
    """The reads (or pairs) the check compares: ``k`` of ``n``, from the
    seed."""
    rng = np.random.default_rng([int(seed), 0x5A11])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


class Drain:
    """The output sink (``drain.py``) in a child process."""

    def __init__(self, fifo: str, names: list[str]):
        self.fifo = fifo
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "drain.py"), fifo],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(names) + "\n")
        self.proc.stdin.flush()

    def wait_pass(self) -> int:
        line = self.proc.stdout.readline()
        if not line.startswith("eof "):
            raise RuntimeError(f"the drain stopped: {line!r}")
        return int(line.split()[1])

    def finish(self) -> list[dict]:
        with open(self.fifo, "wb"):
            pass
        passes = json.loads(self.proc.stdout.readline())
        self.proc.wait(timeout=60)
        return passes

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _child(args: list[str]) -> None:
    subprocess.run([sys.executable] + args, check=True,
                   stdout=subprocess.DEVNULL)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache_root: str | None = None,
             check=None) -> dict:
    """One run on the cell's first ``chips`` cards; returns the result
    line's object.  ``check`` (default: the configuration's ``check``
    module's, else ``compare.check_run``) judges the sampled output."""
    import torch
    cfg, traffic = cell.config, cell.traffic
    chips = int(cell.chips)
    layout = cfg["layout"]
    cache_dir = os.path.join(cache_root or os.path.join(HERE, ".cache"),
                             genome_key(cfg))
    cache_before = _tree_bytes(cache_dir)
    t0 = time.perf_counter()
    _child([os.path.join(HERE, "genome.py"), "--config", cell.config_file,
            "--out", cache_dir])
    genome_s = time.perf_counter() - t0
    run_dir = tempfile.mkdtemp(prefix="bsmap_bench_")
    drain = None
    port = None
    try:
        t0 = time.perf_counter()
        reads = ensure_reads(cell, cache_dir)
        reads_s = time.perf_counter() - t0
        n_pass = int(traffic["pass_size"][layout])
        per = 2 if layout == "pe" else 1
        sample = sample_indices(n_pass, int(traffic["sample"][layout]), seed)
        prefix = "p" if layout == "pe" else "r"
        names = [f"{prefix}{i:09d}" for i in sample]
        fifo = os.path.join(run_dir, "out.sam")
        os.mkfifo(fifo)
        drain = Drain(fifo, names)
        log(f"inputs: genome {genome_s:.3f} s, reads {reads_s:.3f} s "
            f"({n_pass} {layout} a pass)")

        from port import Port, card_peak_bytes
        if device == "cuda":
            torch.cuda.init()
            for i in range(chips):
                torch.cuda.reset_peak_memory_stats(i)
        t_setup = time.perf_counter()
        fasta = os.path.join(cache_dir, "genome.fa")
        port = Port(cfg, traffic, reads, fasta, cache_dir, fifo, seed,
                    device=device, chips=chips)
        port.run_pass(out=os.devnull,
                      read_end=int(traffic["warmup"][layout]))
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup
        log(f"set-up: {setup_s:.3f} s (genome and index {port.load_s:.3f} "
            f"s, engine {port.engine_s:.3f} s)")

        ctx = {"layout": layout, "setup_s": setup_s,
               "engine_s": port.engine_s, "pass_reads": n_pass * per}
        if not trace:
            cpu0 = resource.getrusage(resource.RUSAGE_SELF)
            t_start = time.perf_counter()
            passes = done = 0
            pass_s = []
            while True:
                t_pass = time.perf_counter()
                n = port.run_pass()
                drain.wait_pass()
                pass_s.append(time.perf_counter() - t_pass)
                if n != n_pass:
                    raise RuntimeError(f"a pass took {n} of {n_pass}")
                passes += 1
                done += n * per
                if time.perf_counter() - t_start >= seconds:
                    break
            window_s = time.perf_counter() - t_start
            ctx.update(window_s=window_s, window_reads=done, passes=passes)
            log(f"window: {passes} passes, {done} reads in {window_s:.3f} "
                f"s; pass seconds {[round(x, 3) for x in pass_s]}")
            cpu1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu_s = (cpu1.ru_utime + cpu1.ru_stime
                     - cpu0.ru_utime - cpu0.ru_stime)
            log(f"cpu: {cpu_s:.3f} s of this process's threads over the "
                "window")
        else:
            from bench_trace import traced_pass
            c0 = port.counters()
            port.start_spans()
            try:
                tr = traced_pass(port.run_pass, device)
            finally:
                spans = port.stop_spans()
            drain.wait_pass()
            c1 = port.counters()
            ctx.update(trace=tr, spans=spans, window_s=tr["window_s"],
                       window_reads=tr["n"] * per, passes=1,
                       counters={k: c1[k] - c0[k] for k in c1})
            ctx["stages"] = port.stage_times(device)
            log(f"traced pass: {tr['window_s']:.3f} s, device busy "
                f"{tr['busy_s']:.3f} s; stages {ctx['stages']}")
        passes_out = drain.finish()
        drain = None
        ctx["host_peak_bytes"] = _peak_rss_bytes()
        ctx["device_peak_bytes"] = card_peak_bytes(device, chips)
        port.close()
        port = None

        t0 = time.perf_counter()
        if check is None:
            from spec import load_module
            mod = load_module(cfg, "check")
            if mod is None:
                import compare as mod
            check = mod.check_run
        verdict = check(cfg, traffic, cache_dir, reads, sample,
                        passes_out, device)
        log(f"check: {time.perf_counter() - t0:.3f} s")
        files = _tree_bytes(cache_dir) - cache_before
        log(f"bytes written: {_io_write_bytes()} by /proc/self/io and "
            f"getrusage (this process and its children); {files} in the "
            "files the run made (genome, index and reads in the cache)")
    finally:
        if drain is not None:
            drain.kill()
        if port is not None:
            port.close()
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    result = {"correct": verdict["correct"],
              "attempted": int(ctx["window_reads"]),
              "failed": int(verdict["failed"]),
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": (torch.cuda.get_device_name(0)
                                  if device == "cuda" else "cpu"),
                         "count": chips,
                         "memory_peak_bytes": int(ctx["device_peak_bytes"])}}
    if trace:
        tr = ctx["trace"]
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        from program_spans import idle_by_span
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": idle_by_span(ctx) or []}
    result["checks"] = verdict["checks"]
    return result
