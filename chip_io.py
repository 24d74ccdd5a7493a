#!/usr/bin/env python3
"""Where the time of a gpt_small amp snapshot goes, on a machine with a
CUDA card: one JSON line of seconds.

    python3 chip_io.py

The payload has the leaves of a gpt_small O2 + FusedAdam checkpoint (the
148 parameters' fp32 masters and two moments, 148 int32 step counts: 1.61
GB), random, on the card.  Timed, each with its repeats:

- ``host_copies``: the save's copy to the host (one pinned buffer; the
  first call allocates it, later ones reuse the cached block);
- ``write_snapshot`` with and without fsync (the writer thread's work);
- ``read_snapshot`` with 1 and with ``HASH_THREADS`` hashing threads;
- the floors: sha256 of all the bytes on one thread, the bytes written
  as one file with and without fsync, and one small file a leaf
  fsync'd;
- the training thread's side: 100000 small kernel launches alone, and
  while ``write_snapshot`` runs on another thread.

Snapshots go to a temporary directory, deleted at the end.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_io: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from apex_tpu_torch.models import GPTModel, gpt_small
    from apex_tpu_torch.resilience import durable

    shapes = [tuple(p.shape) for p in
              GPTModel(gpt_small(), device="meta").parameters()]
    leaves = {}
    for kind in ("m", "p", "v"):
        for i, s in enumerate(shapes):
            leaves[f"{kind}{i:03d}"] = torch.randn(s, device="cuda")
    for i in range(len(shapes)):
        leaves[f"s{i:03d}"] = torch.tensor(5, dtype=torch.int32,
                                           device="cuda")
    names = sorted(leaves)
    out = {"device": torch.cuda.get_device_name(0),
           "cpus": os.cpu_count(), "leaves": len(names)}

    def timed(name, fn, reps=1):
        ts, r = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            ts.append(time.perf_counter() - t0)
        out[name] = ts
        return r

    host = timed("host_copies_s",
                 lambda: durable.host_copies([leaves[n] for n in names]), 3)
    payload = dict(zip(names, host))
    root = tempfile.mkdtemp(prefix="chip_io_")
    try:
        for fs in (True, False):
            timed(f"write_snapshot_fsync_{fs}_s",
                  lambda: durable.write_snapshot(root, 1, payload, fsync=fs),
                  2)
        path = os.path.join(root, "step_00000001")
        threads = durable.HASH_THREADS
        for n in (1, threads):
            durable.HASH_THREADS = n
            timed(f"read_snapshot_{n}_hash_threads_s",
                  lambda: durable.read_snapshot(path), 2)
        durable.HASH_THREADS = threads
        flat = torch.cat([t.reshape(-1).view(torch.uint8)
                          for t in host]).numpy()
        out["bytes"] = int(flat.nbytes)
        timed("sha256_one_thread_s",
              lambda: hashlib.sha256(memoryview(flat)).hexdigest())

        def one_file(fsync):
            with open(os.path.join(root, "one.bin"), "wb") as f:
                f.write(memoryview(flat))
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())

        timed("one_file_write_fsync_s", lambda: one_file(True), 2)
        timed("one_file_write_s", lambda: one_file(False), 2)

        def small_fsyncs():
            d = os.path.join(root, "small")
            os.makedirs(d, exist_ok=True)
            for i in range(len(names)):
                with open(os.path.join(d, f"f{i}"), "wb") as f:
                    f.write(b"x" * 128)
                    f.flush()
                    os.fsync(f.fileno())

        timed("small_file_fsyncs_s", small_fsyncs)
        x = torch.zeros(1024, device="cuda")

        def launches(n=100000):
            for _ in range(n):
                x.add_(1.0)
            torch.cuda.synchronize()

        timed("launches_alone_s", launches, 3)
        beside = []
        for _ in range(2):
            th = threading.Thread(target=durable.write_snapshot,
                                  args=(root, 2, payload))
            th.start()
            t0 = time.perf_counter()
            launches()
            beside.append(time.perf_counter() - t0)
            th.join()
        out["launches_beside_a_commit_s"] = beside
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
