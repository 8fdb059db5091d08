"""A wall-clock stack sampler for replica processes, and its summary.

Every `period_s` each thread's stack is read (`sys._current_frames`);
each thread name keeps counts of its innermost frame (file:line) and of
every function on its stack; every 5 s the counts go to DIR/<pid>.json.
It holds the interpreter lock for each read (about 2% of a core at
5 ms), where cProfile slows every call.

Replica processes start it from `tools/sampler_site/sitecustomize.py`:

    PYTHONPATH=tpubft_torch/tools/sampler_site TPUBFT_STACK_SAMPLES=DIR \\
        python3 -c "..."      # e.g. chip_smoke.phase_tls_cluster

(`testing.BftTestNetwork` passes PYTHONPATH and the variable on to its
replica processes.) Then

    python -m tpubft_torch.tools.stack_sampler DIR [--threads replica ...]

prints, a process and a thread, the share of samples in each of the
most frequent innermost lines and functions on the stack.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import threading
import time

ENV = "TPUBFT_STACK_SAMPLES"


def _thread_name(t: threading.Thread) -> str:
    """Thread names without their per-peer or per-instance suffixes."""
    if t.name.startswith("tcp"):
        return t.name.rsplit("-", 1)[0]
    return t.name.split("-")[0]


def start(out_dir: str, period_s: float = 0.005) -> threading.Thread:
    """Sample this process's threads into out_dir/<pid>.json until it
    exits (a daemon thread)."""
    leaf = collections.defaultdict(collections.Counter)
    incl = collections.defaultdict(collections.Counter)
    samples = collections.Counter()

    def dump() -> None:
        data = {n: {"samples": samples[n], "leaf": leaf[n].most_common(25),
                    "incl": incl[n].most_common(60)} for n in samples}
        path = os.path.join(out_dir, f"{os.getpid()}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(data, f)
        os.replace(path + ".tmp", path)

    def run() -> None:
        me = threading.get_ident()
        last = time.monotonic()
        while True:
            time.sleep(period_s)
            names = {t.ident: _thread_name(t) for t in threading.enumerate()}
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                name = names.get(tid, "?")
                samples[name] += 1
                code = frame.f_code
                leaf[name][f"{code.co_name}@"
                           f"{os.path.basename(code.co_filename)}:"
                           f"{frame.f_lineno}"] += 1
                seen = set()
                f, depth = frame, 0
                while f is not None and depth < 40:
                    key = (f"{f.f_code.co_name}@"
                           f"{os.path.basename(f.f_code.co_filename)}")
                    if key not in seen:
                        incl[name][key] += 1
                        seen.add(key)
                    f, depth = f.f_back, depth + 1
            if time.monotonic() - last > 5:
                last = time.monotonic()
                dump()

    os.makedirs(out_dir, exist_ok=True)
    t = threading.Thread(target=run, daemon=True, name="sampler")
    t.start()
    return t


def summarize(out_dir: str, threads=None, top: int = 12) -> dict:
    """{file: {thread: {"samples", "leaf": [[line, share]],
    "incl": [[function, share]]}}} from out_dir's dumps."""
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        out[os.path.basename(path)] = {
            name: {"samples": v["samples"],
                   "leaf": [[k, c / v["samples"]] for k, c in v["leaf"][:top]],
                   "incl": [[k, c / v["samples"]]
                            for k, c in v["incl"][:4 * top]]}
            for name, v in data.items() if not threads or name in threads}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("dir")
    p.add_argument("--threads", nargs="*", default=None)
    args = p.parse_args()
    print(json.dumps(summarize(args.dir, args.threads), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
