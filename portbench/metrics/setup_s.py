"""Set-up: from the process's first statement to the first request of the
window (imports, inputs and ensembles from the seed, the program's server,
kernel builds in a fresh checkout, the warm-up and the graph capture), in
seconds on the host's clock."""


def read(r):
    return r.setup_s
