"""The device's peak allocation over the window (reset at the end of
set-up), in GiB."""


def read(window):
    return window["peak_bytes"] / 2 ** 30
