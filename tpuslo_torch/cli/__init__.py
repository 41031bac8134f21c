"""The port's process entry points (``python -m tpuslo_torch <name>``):
the counterparts of the ``tpuslo/cli`` binaries that have been ported."""
