"""resample_fused_pct.gen: the share of the CRN's resamplings (its layout
pyramid and each feats upsample) that ran as R1's kernel in the traced
slice: its launches over the slice's units times the launches a forward
makes, in percent.  100 when every resampling of every forward took the
kernel, 0 on a program without it.  A count, not a time."""

from benchmark.harness import files


def read(record):
    s = record.slice
    if s is None or not s.units:
        return None
    r1 = files.load_file(record.bench_dir / "kernels" / "R1_crn_resample.py")
    per_unit = r1.LAUNCHES(record.cfg)
    if not per_unit:
        return None
    launches = sum(1 for n, _ in s.kernels if r1.NAME in n)
    return 100.0 * launches / (len(s.units) * per_unit)
