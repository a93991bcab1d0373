"""setup_s (host clock): from the harness's first line to the first
measured step: imports, the beam, the program's set-up and first build,
the warm-up and the step graph's captures (and, in a checkout's first
run, the kernels' builds)."""


def read(ctx):
    return ctx.setup_s
