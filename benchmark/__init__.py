"""The benchmark of sg2im_tpu_torch: ``python3 benchmark/run.py --help``."""
