"""queue_delay_ms.serve: the median of the serving engine's SLO
`queue_delay_ms` (flush start − submit) of the LM prefill steps,
`DRService.metrics()["slo"]`, over the run's requests."""


def read(ctx):
    return ctx.get("queue_delay_p50_ms")
