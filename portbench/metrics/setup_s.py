"""Process start to the first timed submit: imports, the CUDA context, the
kernels' build or load, the DAGs, the service and its warm-up."""
import math


def read(run):
    return run.setup_s if math.isfinite(run.setup_s) else None
