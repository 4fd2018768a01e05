"""mask_fused_pct.gen: the share of the mask head's steps that ran as M1's
kernel in the traced slice: its launches over the slice's units times the
launches a forward makes (one a doubling step), in percent.  100 when
every step of every forward took the kernel, 0 on a program without it.
A count, not a time."""

from benchmark.harness import files


def read(record):
    s = record.slice
    if s is None or not s.units or not record.cfg["model"].get("mask_size"):
        return None
    m1 = files.load_file(record.bench_dir / "kernels" / "M1_mask_head.py")
    launches = sum(1 for n, _ in s.kernels if m1.NAME in n)
    return 100.0 * launches / (len(s.units) * m1.LAUNCHES(record.cfg))
