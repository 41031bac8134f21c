"""Collectors of the port: the live HBM sampler and the parts of the
native ring runtime it writes through (the port's own copies of
``tpuslo/collector/{hbm_sampler,native,ringbuf}.py``)."""
