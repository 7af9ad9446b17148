"""setup_s: seconds from the process's start to the first timed request:
starting torch and CUDA, loading the kernels from the checkout's build
cache (building them on a checkout's first run), making the inputs and
warming the cell's own shapes (a stream's captured programs)."""
UNIT = "s"


def read(run):
    return run.setup_s
