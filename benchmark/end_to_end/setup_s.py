"""The process's start to the window's start, in seconds."""


def read(window):
    return window["setup_s"]
