"""The port's scheduling problems carried into the JAX package's classes,
so the reference's host SGS (``repro.core.sgs``) can schedule the very
instances the port's generators drew."""
import numpy as np

from repro.cluster import catalog as rcatalog
from repro.core import dag as rdag


def as_reference(problem):
    """A ``repro.core.dag.FlatProblem`` with the same tasks, options,
    edges and release times as the port's ``problem``."""
    tasks = [rdag.Task(t.name,
                       [rdag.TaskOption(o.label, o.duration, o.demands, o.cost)
                        for o in t.options],
                       default_option=t.default_option)
             for t in problem.tasks]
    return rdag.FlatProblem(tasks, list(problem.edges),
                            np.asarray(problem.dag_of),
                            list(problem.dag_names),
                            np.asarray(problem.release),
                            problem.num_resources)


def cluster_as_reference(cluster):
    """The reference's ``Cluster`` with the same types and capacities."""
    types = tuple(rcatalog.InstanceType(t.name, t.vcpus, t.memory_gb,
                                        t.price_per_hour)
                  for t in cluster.types)
    return rcatalog.Cluster(types, tuple(cluster.capacities))
