"""One module a model family, found by the `family` of a configuration's
`arch` (`families/<family>.py`), holding all that the benchmark knows of
that family's shapes:

    sizes(fields, dr)             -> the family's `Arch` of the config's `arch`
                                     object (`dr`: its `arch.DRSpec` or None)
    port_config(a)                -> the port's `ArchConfig` of the same sizes
    leaf_specs(a)                 -> (path, shape, scale) of every parameter
                                     leaf, as `weights.py` draws them
    train_flops(a, batch, s)      -> the model's operations, as `flops.py`
    prefill_flops(a, batch, s, prefix_rows)   counts them
    decode_flops(a, batch, s, steps)
    flash_bound_s(a, batch, s, lse)           -> B4's least time a launch

A family's plain reference is `reference/<name>.py`, named by the
configuration's own `reference` key.  A later family is a new file here
and there; nothing else of the benchmark changes.
"""
