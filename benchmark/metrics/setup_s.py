"""setup_s: seconds from the start of the process to the opening of the
window (loading, building the fleet, warming every shape up and, on a
cell's first run in a checkout, compiling the FIR kernel)."""


def read(ctx):
    return ctx.setup_s
