"""setup_s: from the start of the process to the start of the window:
imports, the card's context, the library's load (its build in a run that
builds), the pools and inputs drawn from the seed, and the warm-up steps."""


def read(w):
    return w.setup_s
