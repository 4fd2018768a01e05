"""crn_fused_pct.gen: the share of the CRN's post-convolution chains that
ran as E1's kernel in the traced slice: its launches over the slice's
units times the chains a forward has (two a stage and the head), in
percent.  100 when every chain of every forward took the kernel, 0 on a
program without it.  A count, not a time."""

from benchmark.harness import files


def read(record):
    s = record.slice
    if s is None or not s.units:
        return None
    name = files.load_file(record.bench_dir / "kernels"
                           / "E1_crn_epilogue.py").NAME
    launches = sum(1 for n, _ in s.kernels if name in n)
    chains = 2 * len(record.cfg["model"]["refinement_dims"]) + 1
    return 100.0 * launches / (len(s.units) * chains)
