"""graphik_tpu: a batched distance-geometric inverse-kinematics framework.

Reimplements the capabilities of GraphIK (utiasSTARS/GraphIK) as a
JAX/XLA/Pallas framework that runs on NVIDIA GPUs:

- robots are compiled host-side into static array "templates"
  (:mod:`graphik_tpu.robots`),
- IK problems become static distance matrices + masks
  (:mod:`graphik_tpu.graphs`),
- solvers are batched, jittable pytree programs
  (:mod:`graphik_tpu.solvers`), vmapped over thousands of IK instances
  and sharded over device meshes (:mod:`graphik_tpu.parallel`).

The scaling axis is the *instance batch* (goals x restarts x scenarios);
individual problems are tiny (N ~ 16 nodes) and embarrassingly parallel.
"""

__version__ = "0.1.0"

from graphik_tpu.utils import lie, dgp, geometry
from graphik_tpu.robots.templates import (
    RobotTemplate,
    revolute_from_dh,
    revolute_from_t_zero,
    planar_from_links,
)
from graphik_tpu.graphs.problem import ProblemStructure
