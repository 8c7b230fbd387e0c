"""setup_s (s, host clock): the process's start to the window's start:
imports, kernel build or load, weights from the seed, the program's own
derivations of them, the engine and the warm-up. Moves itself."""
LAYER, UNIT, SOURCE, MOVES = "set-up", "s", "host_clock", "setup_s"


def read(ctx):
    return ctx["setup_s"]
