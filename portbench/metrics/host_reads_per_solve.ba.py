"""host_reads_per_solve.ba: device-to-host copies in the traced window over
the solves it holds (the result's read included: the least is one)."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    return run.trace.count("gpu_memcpy", "DtoH") / len(run.solves)
