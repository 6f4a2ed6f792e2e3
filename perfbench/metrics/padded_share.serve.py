"""The share of the service's device-batch slots that held padding over
the window, in %: the difference of SamplerService.stats()'s
`padded_fields` over that of `device_batches` times the batch size."""


def read(ctx):
    c = ctx.counters
    slots = c.get("device_batches", 0) * c.get("batch_size", 0)
    return 100.0 * c["padded_fields"] / slots if slots else None
