"""Host ms per UNet call: the mean host duration of the traced slice's
first-pass ``unet`` spans (the forward of ``models/unet2d.py`` or
``unet3d.py``, from its entry to its return), waits in the synchronising
operations it holds included."""

from benchmark.program_spans import first_pass, host_seconds


def read(ctx):
    spans = first_pass(ctx)
    unets = [s for s in spans or [] if s["name"] == "unet"]
    if not unets:
        return None
    return 1e3 * sum(host_seconds(s) for s in unets) / len(unets)
