"""``ingest_main(argv)`` — the store's command-line surface:
``python -m mdanalysis_mpi_tpu_torch ingest TRAJ --out DIR``, or
``ingest_main(["TRAJ", "--out", "DIR"])``, or run this file as a script.

Ingest-once: re-chunk a trajectory into the block store
(docs/STORE.md), then point every later run at the store directory
instead of the file (``batch --store=DIR``, or simply pass the
directory where a trajectory path is expected — the format registry
recognizes ingested stores).  Ingest is a host decode pass: it imports
no torch device code and needs no GPU.

``--smoke`` runs the self-contained ingest→read verification gate
(``scripts/verify.sh`` stage): write a tiny synthetic XTC, ingest it,
prove read parity against the file reader, and prove a corrupt chunk
is rejected typed — then repeat the gate through the HTTP fixture
backend (in-process ``ChunkServer``): content-addressed ingest, a
two-tenant dedup proof (second ingest moves zero chunk bytes), remote
read parity, and a corrupt-wire-body typed rejection.  One JSON line,
exit 0 on success.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch ingest",
        description="re-chunk a trajectory into the native block "
                    "store: ingest-once, random-access, quantized "
                    "(docs/STORE.md)")
    p.add_argument("trajectory", nargs="*", default=[],
                   help="trajectory file(s) to ingest (any registered "
                        "format: XTC/DCD/TRR/...); several files + "
                        "--out-root run the parallel ensemble ingest "
                        "(docs/ENSEMBLE.md)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="store directory (created if missing) — "
                        "single-trajectory mode")
    p.add_argument("--out-root", default=None, metavar="DIR",
                   help="ensemble root: member stores land at "
                        "DIR/m0000, DIR/m0001, ... with cas-* chunk "
                        "bytes deduplicated across members through "
                        "the shared DIR/cas hardlink pool")
    p.add_argument("--jobs", type=int, default=None, metavar="N",
                   help="parallel member ingests (default: one per "
                        "trajectory, capped at the CPU count)")
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="frames per chunk (default 512 — the flagship "
                        "staging batch; match your executor batch_size "
                        "so every stage call is one chunk slice)")
    p.add_argument("--quant", default="int16",
                   choices=("int16", "int8", "f32"),
                   help="coordinate tier: int16 (wire default, "
                        "~0.004 Å at 120 Å range), int8 (coarse), "
                        "f32 (lossless passthrough)")
    p.add_argument("--stop", type=int, default=None,
                   help="ingest only frames [0, STOP)")
    p.add_argument("--force", action="store_true",
                   help="re-ingest even if DIR already holds a store")
    p.add_argument("--smoke", action="store_true",
                   help="self-contained ingest→read→corrupt-reject "
                        "verification gate (no arguments needed)")
    return p


def ingest_main(argv=None) -> int:
    ns = _parser().parse_args(argv)
    if ns.smoke:
        return _smoke()
    if ns.out_root is not None or len(ns.trajectory) > 1:
        # parallel ensemble ingest: N members fanned on a thread
        # pool, content-addressed dedup across members, aggregate
        # dedup_ratio in the summary (docs/ENSEMBLE.md)
        if not ns.trajectory or not ns.out_root:
            print(json.dumps({
                "error": "ensemble ingest needs >= 1 trajectory and "
                         "--out-root DIR (use --out for a single "
                         "store)"}))
            return 2
        from mdanalysis_mpi_tpu_torch.io.store.parallel import ingest_many

        summary = ingest_many(ns.trajectory, ns.out_root,
                              jobs=ns.jobs,
                              chunk_frames=ns.chunk_frames,
                              quant=ns.quant, stop=ns.stop,
                              force=ns.force)
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
    if not ns.trajectory or not ns.out:
        print(json.dumps({"error": "ingest needs a trajectory and "
                                   "--out DIR (or --smoke)"}))
        return 2
    from mdanalysis_mpi_tpu_torch.io.store import ingest, store_meta

    existing = store_meta(ns.out)
    if existing is not None and not ns.force:
        # ingest-once honored literally: an existing verified store is
        # the answer, not an error (--force re-ingests)
        print(json.dumps({
            "store": ns.out, "already_ingested": True,
            "n_frames": existing["n_frames"],
            "n_chunks": len(existing["chunks"]),
            "quant": existing["quant"],
            "chunk_frames": existing["chunk_frames"]}))
        return 0
    summary = ingest(ns.trajectory[0], ns.out,
                     chunk_frames=ns.chunk_frames, quant=ns.quant,
                     stop=ns.stop)
    print(json.dumps(summary))
    return 0


def _smoke() -> int:
    """Ingest→read smoke: parity vs the file reader + typed
    corrupt-chunk rejection, in a temp dir, ~a second, host only."""
    import os
    import tempfile

    import numpy as np

    from mdanalysis_mpi_tpu_torch.io.store import StoreReader, ingest
    from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc
    from mdanalysis_mpi_tpu_torch.utils.integrity import IntegrityError

    out: dict = {"smoke": "ingest-read"}
    with tempfile.TemporaryDirectory() as td:
        rng = np.random.default_rng(7)
        frames = rng.normal(scale=12.0,
                            size=(24, 300, 3)).astype(np.float32)
        xtc = os.path.join(td, "smoke.xtc")
        write_xtc(xtc, frames,
                  dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
                  times=np.arange(24, dtype=np.float32))
        store = os.path.join(td, "smoke.store")
        summary = ingest(xtc, store, chunk_frames=8, quant="int16")
        out.update(n_chunks=summary["n_chunks"],
                   store_ingest_fps=summary["store_ingest_fps"])

        src = XTCReader(xtc)
        sr = StoreReader(store)
        ref, _ = src.read_block(0, 24)
        got, _ = sr.read_block(0, 24)
        # one int16 round trip at this range: ~1e-3 Å resolution
        err = float(np.abs(got - ref).max())
        out["read_parity_max_err"] = round(err, 6)
        if err > 5e-3:
            out["error"] = f"store read diverged from file read: {err}"
            print(json.dumps(out))
            return 1
        # the staging fast path serves raw int16 under one scale
        q, _boxes, inv = sr.stage_block(8, 16, quantize="int16")
        if q.dtype != np.int16:
            out["error"] = f"fast path returned {q.dtype}, not int16"
            print(json.dumps(out))
            return 1
        # corrupt one payload byte -> typed rejection, not wrong data
        chunk_path = os.path.join(store, "chunk-00000001.mdtc")
        blob = bytearray(open(chunk_path, "rb").read())
        blob[-10] ^= 0x40
        with open(chunk_path, "wb") as f:
            f.write(bytes(blob))
        fresh = StoreReader(store)
        try:
            fresh.read_block(8, 16)
        except IntegrityError as exc:
            out["corrupt_chunk_rejected"] = type(exc).__name__
        else:
            out["error"] = "corrupt chunk was served instead of rejected"
            print(json.dumps(out))
            return 1

        # ---- remote leg: the same gate through the HTTP fixture ----
        # (in-process ChunkServer, still host only: ingest→read-parity→
        # corrupt-reject over the hardened network boundary, plus the
        # two-tenant content-addressing dedup proof — docs/STORE.md
        # "Remote backend")
        from mdanalysis_mpi_tpu_torch.io.store import (
            ChunkCache, ChunkServer, HttpStoreBackend, ServerFault,
        )

        with ChunkServer(os.path.join(td, "chunkd")) as srv:
            be1 = HttpStoreBackend(srv.url, store="tenant-a",
                                   cache=ChunkCache(), timeout_s=5.0)
            rsum = ingest(xtc, backend=be1, chunk_frames=8,
                          quant="int16")
            out["remote_n_chunks"] = rsum["n_chunks"]
            # tenant B ingests the SAME trajectory: every chunk must
            # dedup against tenant A's CAS objects — zero new bytes
            wrote_before = srv.cas_bytes_written
            be2 = HttpStoreBackend(srv.url, store="tenant-b",
                                   cache=ChunkCache(), timeout_s=5.0)
            rsum2 = ingest(xtc, backend=be2, chunk_frames=8,
                           quant="int16")
            out["remote_dedup_ratio"] = rsum2["dedup_ratio"]
            if rsum2["dedup_ratio"] != 1.0 \
                    or srv.cas_bytes_written != wrote_before:
                out["error"] = ("second-tenant ingest moved chunk "
                                "bytes instead of deduplicating")
                print(json.dumps(out))
                return 1
            rr = StoreReader(srv.url + "/stores/tenant-a",
                             backend=be1)
            rgot, _ = rr.read_block(0, 24)
            rerr = float(np.abs(rgot - ref).max())
            out["remote_parity_max_err"] = round(rerr, 6)
            if rerr > 5e-3:
                out["error"] = (f"remote read diverged from file "
                                f"read: {rerr}")
                print(json.dumps(out))
                return 1
            # a corrupt remote body (flipped payload byte on the
            # wire) must be rejected typed by the content address —
            # and must NOT poison the cache with bad bytes
            from mdanalysis_mpi_tpu_torch.io.store.manifest import (
                load_manifest,
            )

            chunk0 = load_manifest(be1)["chunks"][0]["file"]
            srv.inject(ServerFault("corrupt", match=chunk0,
                                   times=None))
            be3 = HttpStoreBackend(srv.url, store="tenant-a",
                                   cache=ChunkCache(), timeout_s=5.0,
                                   retries=0)
            try:
                be3.get_bytes(chunk0)
            except IntegrityError as exc:
                out["remote_corrupt_rejected"] = type(exc).__name__
            else:
                out["error"] = ("corrupt remote body was served "
                                "instead of rejected")
                print(json.dumps(out))
                return 1
    out["ok"] = True
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(ingest_main())
