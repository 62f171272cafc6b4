"""The device's idle share of the traced stretch, in %: 100 minus the union
of its operations' intervals over the stretch's length."""


def read(r):
    return 100.0 * r.idle_share()
