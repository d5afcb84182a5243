"""One driver a kind of work: ``train`` and ``serve``.  A driver's
``run(ctx)`` loads, warms up, measures for ``ctx.seconds`` and checks
what the timed path produced; it returns a :class:`Outcome`."""


def config_fields(llama, torch, cfg):
    """The program's config fields from a configuration file: the keys
    ``LlamaConfig`` has, ``dtype`` as a torch dtype."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(llama.LlamaConfig)}
    fields = {k: v for k, v in cfg.items() if k in names}
    fields["dtype"] = getattr(torch, cfg["dtype"])
    return fields
