#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 tools/profile_torch_serving.py [--chained int8|bf16 | --admission]

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
(``_step_eager``, every op launched from the host), for comparison.  For
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
host and back).  Needs one CUDA card.
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
    parser.add_argument("--admission", action="store_true",
                        help="profile phase 3b's prefix hits, prefill chunks and parking")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from paddle_tpu_torch import set_flags

    print(card_line(), flush=True)
    cache_dir = tempfile.mkdtemp(prefix="autotune-")
    if args.chained or args.admission:
        set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": cache_dir})
    try:
        if args.admission:
            return _run_admission(chip_smoke)
        return _run(chip_smoke, chip_smoke.CHAINED[args.chained] if args.chained else {})
    finally:
        set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run(chip_smoke, engine_kw) -> int:
    with torch.no_grad():
        model, engine, prompts, new = chip_smoke.build_engine(**engine_kw)
        longest = max(prompts.values(), key=len)
        others = [p for p in prompts.values() if p is not longest]

        def prefill_longest(tag):
            engine.add_request(f"{tag}-long", longest, max_new_tokens=new)

        for i, p in enumerate(others):  # warm every shape, then fill 3 lanes
            engine.add_request(f"warm-{i}", p, max_new_tokens=2)
        prefill_longest("warm")
        while engine.has_work():
            engine._step_eager()
        engine.warmup()
        for i, p in enumerate(others):
            engine.add_request(f"busy-{i}", p, max_new_tokens=new)
        plain_prefill = _wall(lambda: prefill_longest("plain"))
        plain_step = _wall(engine.step)
        plain_eager_step = _wall(engine._step_eager)
        # the profiled pair runs on a fresh set of the same requests
        while engine.has_work():
            engine.step()
        for i, p in enumerate(others):
            engine.add_request(f"prof-{i}", p, max_new_tokens=new)
        if engine_kw and not (engine._decode_chain_cfg and engine._prefill_chain_cfg):
            raise RuntimeError(f"a serving chain lost the measured-win gate: "
                               f"{engine.decode_decision} {engine.prefill_decision}")
        d = engine._effective_chunk()
        label = (f", {engine_kw['kv_cache_dtype']} pools, chains {engine._decode_chain_cfg} "
                 f"{engine._prefill_chain_cfg}" if engine_kw else "")
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


if __name__ == "__main__":
    sys.exit(main())
