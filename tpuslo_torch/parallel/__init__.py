"""Device meshes for the port's training path (the counterpart of
``tpuslo/parallel``).  Only the one-device part of :mod:`.mesh` is
ported: the shardings, collectives and pipeline schedules belong to the
multi-device slice (ROADMAP item 13)."""
