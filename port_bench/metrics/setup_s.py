"""Seconds from the process's start to the window's: imports, the draw of
the inputs, the program's set-up and warm-up (and, in a checkout's first
run, compilation)."""


def read(rec):
    return rec.setup_s
