#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 tools/profile_torch_serving.py [--chained int8|bf16 [--adapters] | --admission
                                            | --snapshot]

Builds the ``chip_smoke.py`` phase-3 configuration (LLaMA-7B width, bf16,
32 layers, batch 4): the default engine, or with ``--chained`` the engine
over int8 (or bf16) pools with ``prefill_chunk=128`` and
FLAGS_schedule_search on (a fresh FLAGS_autotune_cache_dir, so its warm-up
searches both serving chains; the run fails unless both are accepted).
It warms the engine up (one pass through the eager body, then
``warmup()``, which captures the decode step as a CUDA graph), then
traces under ``torch.profiler`` (a) the prefill of the 640-token prompt,
(b) one decode ``step()`` of D = 8 tokens for 4 resident requests, a
replay of the captured step, and (c) the same step through the eager body
(``_step_eager``, every op launched from the host), for comparison.
With ``--adapters`` the engine also holds ``chip_smoke.py`` phase 3d's
adapter pack (4 rank-16 slots) and the three shorter requests decode
through three seeded adapters (the longest through the base model).  For
each it prints one JSON line: wall
time with and without the profiler, the time the card was busy (kernel,
copy and memset events only, overlaps counted once) and its share of the
profiled wall time (the rest is the card waiting on the host), the device
events (also per decode token iteration), and the kernels with the most
device time.  With ``--admission`` it profiles ``chip_smoke.py`` phase
3b's admission work instead: on the chained int8 engine with the prefix
cache, the admission of a 612-token prompt that hits the 512-token system
prompt's 32 pages, beside the same prompt's admission on the same engine
without the prefix cache (a miss); on the bf16 engine with interleaved
prefill, one 16-token prefill chunk in the middle of a 612-token prompt;
and the parking and unparking of a resident request (its pages to the
host and back).  With ``--snapshot`` it times ``chip_smoke.py`` phase
3e's snapshot of the chained int8 adapter engine with the prefix cache
(four requests resident, four queued) and its restore, each split into
its parts on the host clock: the pools' copy to pinned host memory, the
pickled host state, the writes (each fsynced), the manifest's hashes and
the rename; the manifest check, the load, the copy into the fresh
engine's pools and the adapters' installs.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_events(prof, exclude=()):
    """The profile's device activity only (kernels, copies, memsets): its
    CUDA-side events, without the host ops that launched them and without
    user annotations (named in ``exclude`` too, for torch versions that do
    not mark them), whose ranges repeat the time of what they enclose."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("aten::") and e.name not in exclude]


def busy_us(events):
    """Device time covered by at least one of ``events`` (overlaps once)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def top_kernels(events, top, per=1):
    """The ``top`` kernel names by device time, each with its launch count
    and device ms, both divided by ``per``."""
    by_name = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": k[:80], "count": n / per, "device_ms": us / 1e3 / per}
            for k, (n, us) in rows]


def profile(name, fn, plain_wall_s, top=10, per=1):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall(fn)
    events = device_events(prof)
    busy_s = busy_us(events) / 1e6
    if not 0 < busy_s <= wall:
        raise RuntimeError(f"{name}: device busy {busy_s} s outside (0, wall {wall} s]")
    print(json.dumps({
        "phase": name, "wall_s": plain_wall_s, "profiled_wall_s": wall,
        "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
        "device_kernel_s": sum(e.time_range.elapsed_us() for e in events) / 1e6,
        "kernels_launched": len(events), "events_per_iteration": len(events) / per,
        "top_kernels": top_kernels(events, top),
    }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chained", choices=("int8", "bf16"), default=None,
                        help="profile the engine that runs the searched serving chains")
    parser.add_argument("--adapters", action="store_true",
                        help="serve through phase 3d's adapter pack (with --chained)")
    parser.add_argument("--admission", action="store_true",
                        help="profile phase 3b's prefix hits, prefill chunks and parking")
    parser.add_argument("--snapshot", action="store_true",
                        help="time phase 3e's snapshot and restore, part by part")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from paddle_tpu_torch import set_flags

    print(card_line(), flush=True)
    cache_dir = tempfile.mkdtemp(prefix="autotune-")
    if args.chained or args.admission or args.snapshot:
        set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": cache_dir})
    try:
        if args.admission:
            return _run_admission(chip_smoke)
        if args.snapshot:
            return _run_snapshot(chip_smoke)
        kw = dict(chip_smoke.CHAINED[args.chained]) if args.chained else {}
        return _run(chip_smoke, kw, args.adapters)
    finally:
        set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run(chip_smoke, engine_kw, adapters=False) -> int:
    with torch.no_grad():
        model, engine, prompts, new = chip_smoke.build_engine(
            **engine_kw, **(chip_smoke.LORA_ENGINE if adapters else {}))
        longest = max(prompts.values(), key=len)
        others = [p for p in prompts.values() if p is not longest]
        names = [None] * len(others)
        if adapters:
            names = [f"t{i}" for i in range(len(others))]
            for i, name in enumerate(names):
                engine.register_adapter(name, chip_smoke.lora_adapter(model, 20 + i))

        def prefill_longest(tag):
            engine.add_request(f"{tag}-long", longest, max_new_tokens=new)

        for i, p in enumerate(others):  # warm every shape, then fill 3 lanes
            engine.add_request(f"warm-{i}", p, max_new_tokens=2, adapter=names[i])
        prefill_longest("warm")
        while engine.has_work():
            engine._step_eager()
        engine.warmup()
        for i, p in enumerate(others):
            engine.add_request(f"busy-{i}", p, max_new_tokens=new, adapter=names[i])
        plain_prefill = _wall(lambda: prefill_longest("plain"))
        plain_step = _wall(engine.step)
        plain_eager_step = _wall(engine._step_eager)
        # the profiled pair runs on a fresh set of the same requests
        while engine.has_work():
            engine.step()
        for i, p in enumerate(others):
            engine.add_request(f"prof-{i}", p, max_new_tokens=new, adapter=names[i])
        if engine_kw and not (engine._decode_chain_cfg and engine._prefill_chain_cfg):
            raise RuntimeError(f"a serving chain lost the measured-win gate: "
                               f"{engine.decode_decision} {engine.prefill_decision}")
        d = engine._effective_chunk()
        label = (f", {engine_kw['kv_cache_dtype']} pools, chains {engine._decode_chain_cfg} "
                 f"{engine._prefill_chain_cfg}" if engine_kw else "")
        if adapters:
            label += f", adapters rank {chip_smoke.LORA_RANK} ({len(names)} of the 4 rows)"
        profile(f"prefill {len(longest)} tokens{label}", lambda: prefill_longest("prof"),
                plain_prefill)
        profile(f"decode step D={d} batch 4{label}, graphed", engine.step, plain_step, per=d)
        profile(f"decode step D={d} batch 4{label}, eager", engine._step_eager,
                plain_eager_step, per=d)
    return 0


def _run_admission(chip_smoke) -> int:
    with torch.no_grad():
        model = chip_smoke.build_model()
        system, prompts = chip_smoke.admission_prompts(model.config)
        suffix = prompts["s100"][len(system):]
        variant = iter(range(1000, 2000))

        def fresh():
            """The s100 request with a first suffix token no earlier
            admission used: it hits exactly the system prompt's pages."""
            return system + [next(variant)] + suffix[1:]

        hit_eng = chip_smoke.admission_engine(model, **chip_smoke.CHAINED["int8"],
                                              prefix_cache=True)
        miss_eng = chip_smoke.admission_engine(model, **chip_smoke.CHAINED["int8"])
        hit_eng.add_request("system", prompts["s17"], max_new_tokens=1)  # pours the prompt
        for eng in (hit_eng, miss_eng):  # max_new_tokens=1: done at admission
            for i in range(2):
                eng.add_request(f"warm{i}", fresh(), max_new_tokens=1)
        for tag, eng in (("hit", hit_eng), ("miss", miss_eng)):
            plain = _wall(lambda: eng.add_request(f"{tag}-plain", fresh(), max_new_tokens=1))
            profile(f"admission of {len(fresh())} tokens, int8 chained, prefix {tag}",
                    lambda: eng.add_request(f"{tag}-prof", fresh(), max_new_tokens=1), plain)
        del hit_eng, miss_eng

        eng = chip_smoke.admission_engine(model, prefix_cache=True,
                                          prefill_chunk_blocks=chip_smoke.INTERLEAVED_BLOCKS)
        eng.warmup()
        eng.add_request("long", prompts["s100"], max_new_tokens=chip_smoke.SERVE_NEW)
        eng._admit_pending()
        slot = next(s for s in eng._slots if s.rid == "long")
        for _ in range(20):
            eng._prefill_chunk_step(slot)
        plain = _wall(lambda: eng._prefill_chunk_step(slot))
        profile(f"interleaved prefill chunk of {eng.block_size} tokens at "
                f"{slot.prefill.off} cached, bf16", lambda: eng._prefill_chunk_step(slot), plain)
        while slot.prefill is not None:
            eng._prefill_chunk_step(slot)

        def lane():
            return next(s for s in eng._slots if s.rid == "long")

        def unpark():
            if not eng._try_unpark("long"):
                raise RuntimeError("the parked request did not come back")

        pages = len(lane().blocks)
        plain_park = _wall(lambda: eng._park_request(lane()))
        plain_unpark = _wall(unpark)
        profile(f"park of {pages} pages x {2 * len(eng._kpools)} pools, bf16",
                lambda: eng._park_request(lane()), plain_park)
        profile("unpark of the same", unpark, plain_unpark)
    return 0


def _run_snapshot(chip_smoke) -> int:
    import os
    import pickle

    from paddle_tpu_torch.distributed.checkpoint import manager as ckpt
    from paddle_tpu_torch.serving import EngineSnapshot
    from paddle_tpu_torch.serving import snapshot as snap

    parts = {}

    def timed(name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def wrap(module, name):
        fn = getattr(module, name)
        setattr(module, name, lambda *a, **k: timed(name, fn, *a, **k))
        return fn

    with torch.no_grad():
        model = chip_smoke.build_model()
        _, prompts = chip_smoke.admission_prompts(model.config)
        eng = chip_smoke.admission_engine(model, **chip_smoke.CHAINED["int8"], prefix_cache=True,
                                          **chip_smoke.LORA_ENGINE)
        for i in range(2):
            eng.register_adapter(f"t{i}", chip_smoke.lora_adapter(model, 30 + i))
        eng.warmup()
        for (rid, p), ad in zip(prompts.items(), chip_smoke.SNAPSHOT_ADAPTERS):
            eng.add_request(rid, p, max_new_tokens=chip_smoke.SERVE_NEW, adapter=ad)
        eng.step()
        eng.step()
        root = Path(tempfile.mkdtemp(prefix="engine-snapshot-"))
        try:
            eng.snapshot(root / "warm")  # pinned allocations and the write path warmed
            # parts may nest: the manifest's hashes (_sha256_file) lie inside
            # the restore's manifest check, the manifest's write inside
            # write_fsynced's total
            originals = [(snap, "_pools_to_host"), (snap, "_capture_host_state"),
                         (ckpt, "write_fsynced"), (ckpt, "_sha256_file"), (ckpt, "_fsync_dir")]
            saved = [(m, n, wrap(m, n)) for m, n in originals]
            try:
                save_ms = _wall(lambda: eng.snapshot(root / "timed", step=1)) * 1e3
                save_parts = dict(parts)
                parts.clear()
                nbytes = sum(os.path.getsize(root / "timed" / "step_00000001" / f)
                             for f in os.listdir(root / "timed" / "step_00000001"))
                store = EngineSnapshot(root / "timed")
                path, extras = timed("manifest check and extras", store._resolve, 1)
                fresh = chip_smoke.admission_engine(
                    model, **chip_smoke.CHAINED["int8"], prefix_cache=True,
                    **chip_smoke.LORA_ENGINE)
                timed("pools copied in, host state, adapters installed", snap._load_state,
                      fresh, path, extras)
                restore_parts = dict(parts)
            finally:
                for m, n, fn in saved:
                    setattr(m, n, fn)
            restore_ms = _wall(lambda: snap.restore_engine(model, root / "timed",
                                                           device=chip_smoke.DEVICE)) * 1e3
            print(json.dumps({
                "phase": "snapshot of phase 3e's engine (int8 pools, prefix cache, two "
                         "adapters; 4 resident, 4 queued)", "bytes": nbytes,
                "save_ms": save_ms, "save_parts_ms": save_parts,
                "extras_pickle_bytes": len(pickle.dumps(snap._capture_host_state(eng))),
                "restore_ms": restore_ms, "restore_parts_ms": restore_parts,
                "save_gb_per_s": nbytes / save_ms / 1e6,
                "restore_gb_per_s": nbytes / restore_ms / 1e6}), flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
