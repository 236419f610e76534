"""`device_idle_pct.<cell>`: the share of the traced window in which no
operation ran on the card: 1 - the union of the device activity
intervals over the window, in percent."""

from lingambench.lib import readers


def read(ctx, metric):
    return readers.idle_pct(ctx)
