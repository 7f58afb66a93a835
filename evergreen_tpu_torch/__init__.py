"""The packed scheduling solve on PyTorch and an NVIDIA Hopper card.

A port of the device half of ``evergreen_tpu``: the snapshot layout, the
batched solve (planner, allocator, capacity + affinity), the solver
sidecar and solver-leader plane, and the tick's planning half from a
store (gather, snapshot, bounded solve, unpack, capacity plane). It
imports ``torch`` and numpy and nothing of ``evergreen_tpu`` or JAX.
Entry points (``ops.solve.run_solve_packed``,
``ops.capacity.run_capacity_solve``, ``api.sidecar.serve``,
``python -m evergreen_tpu_torch solver``) run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
