"""Device ms per UNet call of PyTorch's eager elementwise, copy and norm
kernels (``harness.kernel_class``'s ``elementwise/copy`` and ``norm``) in
the traced slice."""


def read(ctx):
    sl = ctx.get("slice") or {}
    cls = sl.get("by_class") or {}
    if not sl.get("unet_calls") or not cls:
        return None
    return 1e3 * (cls.get("elementwise/copy", 0.0) + cls.get("norm", 0.0)) / sl["unet_calls"]
