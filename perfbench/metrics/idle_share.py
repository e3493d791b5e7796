"""Share of the traced window in which no operation ran on the device:
one minus the union of the device events' intervals over the window,
in percent."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
