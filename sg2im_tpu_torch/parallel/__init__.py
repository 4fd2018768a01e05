"""Data and tensor parallelism of the port (counterpart of
``sg2im_tpu/parallel/``): the device mesh, the launch of a process group,
and the sums across its ranks that make a data-parallel step compute what
the one-process step computes on the global batch."""
