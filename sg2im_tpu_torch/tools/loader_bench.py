"""Loader benchmark of the port: decode backends and the decoded-sample
cache against raw decode, beside the training step's rate.

Port of ``scripts/loader_bench.py``.  On ``tools.train_proof``'s disk
dataset it measures:

1. one thread's raw decode, ms an image, per backend (pil / native /
   native_fast, ``data/decode.py``);
2. one thread's cached read, ms an image (memmap slice + triples);
3. ``PaddedLoader`` images a second at one worker from the cache and from
   raw decode (and, with the native decoder, per sample and per batch at
   1 and 4 workers),

each against the rate the training step consumes images at: a card's own,
``--step_rate`` img/s or the steady-state rate of a train_proof run
(``--proof_report <out>/train_proof.json``).  One worker should feed it.

    python -m sg2im_tpu_torch.tools.loader_bench --proof_report R.json
        [--images 2048] [--out DIR] [--src_hw 480]

``--src_hw 480`` builds source JPEGs of production size (COCO images are
about 640x480; decode cost scales with source pixels).  The dataset and
the cache go under ``<out>/src<hw>`` and are reused when present.  The
last line is a JSON object of the numbers.  Runs on the host alone.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from sg2im_tpu_torch.tools.train_proof import build_dataset, open_dataset


def rate(fn, n, warmup=20):
    """Calls of ``fn(i)`` a second over max(200, min(n, 2000)) calls, and
    ms a call."""
    for i in range(warmup):
        fn(i % n)
    t0 = time.perf_counter()
    cnt = max(200, min(n, 2000))
    for i in range(cnt):
        fn(i % n)
    dt = time.perf_counter() - t0
    return cnt / dt, dt / cnt * 1e3


def loader_rate(ds, batch_size, workers, batch_decode, n_batches=40):
    """``PaddedLoader`` images a second over ``n_batches`` batches (or to
    the end of the epoch) after one warm-up batch."""
    from sg2im_tpu_torch.data.loader import PaddedLoader

    loader = PaddedLoader(ds, batch_size=batch_size, O_max=16, T_max=16,
                          num_workers=workers, seed=0,
                          batch_decode=batch_decode)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    nb = 0
    for _ in it:
        nb += 1
        if nb >= n_batches:
            break
    dt = time.perf_counter() - t0
    it.close()
    return nb * batch_size / dt


def step_rate_of(args) -> tuple[float, str]:
    if args.step_rate is not None:
        return args.step_rate, "--step_rate"
    with open(args.proof_report) as f:
        proof = json.load(f)
    where = proof.get("card") or proof.get("device")
    return (float(proof["steady_img_s"]),
            f"train_proof {proof['mode']} b{proof['batch_size']} on {where}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "loaderbench"))
    rate_src = ap.add_mutually_exclusive_group(required=True)
    rate_src.add_argument("--step_rate", type=float, default=None,
                          help="img/s the training step consumes")
    rate_src.add_argument("--proof_report", default=None,
                          help="train_proof.json of a train_proof run: its "
                               "steady-state img/s is the step rate")
    ap.add_argument("--src_hw", type=int, default=64,
                    help="source JPEG side (480 ~ production COCO)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    step_rate, rate_from = step_rate_of(args)
    out = os.path.join(args.out, f"src{args.src_hw}")
    os.makedirs(out, exist_ok=True)
    if not os.path.exists(os.path.join(out, "instances.json")):
        print(f"building {args.images}-image disk dataset "
              f"(src {args.src_hw}px) ...", flush=True)
        build_dataset(out, n_images=args.images, hw=args.src_hw)
    paths = (os.path.join(out, "images"), os.path.join(out, "instances.json"),
             os.path.join(out, "stuff.json"))

    from sg2im_tpu_torch.data.decode import resolve_decoder

    print(f"step rate {step_rate:.1f} img/s ({rate_from})")
    result = {"step_rate": step_rate, "step_rate_from": rate_from,
              "src_hw": args.src_hw, "raw_ms": {}, "loader_img_s": {}}
    raw_ms = None
    for dec in ("pil", "native", "native_fast"):
        if dec != "pil" and resolve_decoder(dec) == "pil":
            print(f"raw decode [{dec}]: native decoder unavailable, skipped")
            continue
        ds = open_dataset(*paths, decoder=dec)
        ips, ms = rate(ds.__getitem__, len(ds))
        rel = f"  ({raw_ms / ms:.2f}x pil)" if raw_ms else ""
        print(f"raw decode [{dec:11s}] (1 thread): {ms:6.3f} ms/img "
              f"= {ips:7.0f} img/s{rel}")
        result["raw_ms"][dec] = ms
        if dec == "pil":
            raw_ds, raw_ms = ds, ms
    n = len(raw_ds)

    t0 = time.perf_counter()
    cached_ds = open_dataset(*paths, cache_dir=os.path.join(out, "cache"))
    result["cache_build_s"] = time.perf_counter() - t0
    print(f"cache build: {result['cache_build_s']:.1f} s one-time "
          f"({n} samples)")
    c_ips, c_ms = rate(cached_ds.__getitem__, n)
    result["cached_ms"] = c_ms
    print(f"cached read    (1 thread): {c_ms:6.3f} ms/img "
          f"= {c_ips:7.0f} img/s  ({raw_ms / c_ms:.1f}x raw)")

    rows = [("cached", cached_ds, 1, False), ("raw", raw_ds, 1, False)]
    if resolve_decoder("native") == "native":
        nat = open_dataset(*paths, decoder="native")
        # One GIL-free C++ pool call a batch against per-sample threaded
        # decode.
        rows += [("nat/sample", nat, 1, False), ("nat/batch", nat, 1, True),
                 ("nat/sample4", nat, 4, False), ("nat/batch4", nat, 4, True)]
    for name, ds, workers, bd in rows:
        ips = loader_rate(ds, args.batch_size, workers, bd)
        result["loader_img_s"][name] = ips
        verdict = ("OK >= step rate" if ips >= step_rate
                   else f"{ips / step_rate:.2f}x of step rate")
        print(f"PaddedLoader {name:11s} ({workers} worker): "
              f"{ips:7.0f} img/s   [{verdict} vs {step_rate:.0f}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
