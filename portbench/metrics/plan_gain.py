"""The mean, over every DAG planned in the window, of minus the paper's
Eq. 1 energy of the program's plan against the default Airflow plan of the
same DAGs (default options, downstream-count priority) at the
configuration's goal, both recomputed by the reference (``run.gains``)."""


def read(run):
    return sum(run.gains) / len(run.gains) if run.gains else None
