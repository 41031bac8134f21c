"""Command-line fault injectors on the card (the port of
``scripts/chaos/injectors/``): ``python -m
tpuslo_torch.chaos.injectors.{ici_contention,hbm_pressure,xla_recompile_storm}``.
Each exits 2 with a ``"real": false`` report when no card answers."""
