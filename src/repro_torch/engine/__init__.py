"""DSO engine of the port: tile backends, schedules and the epoch driver.

      Problem --make_grid_data (dense) / make_sparse_grid_data /
                make_bucketed_grid_data--------------------------+
      CSRMatrix --sparse_grid_from_csr / bucketed_grid_from_csr--+
                                                                 v
        GridData | SparseGridData | BucketedGridData (tensors on one device)
                                   | as_tile_data
                                   v
      TileData (arrays = (Xg,) | (cols_g, vals_g) |
                (cols_fl, vals_fl, lut, cnt) | per-bucket (cols, vals)...
                + (bucket_id, bucket_pos) for the *_switch backends)
                                   |
      schedules.py: perms (n_epochs, p, p) --> driver.py: run_epochs
                                                 epoch_body: p inner
                                                 iterations, each ONE
                                                 batched block step of
                                                 all p processors
                                   |
      backends.py: dense_jnp | sparse_jnp | sparse_bucketed_jnp
                                                       (plain PyTorch)
                   dense_pallas_block | dense_pallas_fused |
                   sparse_pallas | sparse_bucketed_pallas (CUDA kernels,
                   kernels/ops.py -> csrc/dso_update.cu, dso_sparse.cu);
                   sparse_bucketed_{jnp,pallas}_switch (the legacy
                   per-bucket dispatch onto the block-ELL steps)
                                   |
                                   v  (DSOState updated in place)
      solve() -> SolveResult(w, alpha, history, state); evaluation hooks
      in evaluate.py (Problem objectives, device CSR primal).

      solve_serial(): the paper-exact p = 1 epochs, one
      ops.dso_serial_epoch (csrc/dso_serial.cu) per epoch.

      solve()'s duck-typed seams: checkpoint_every / store / init / health
      (repro_torch.runtime: snapshots, resume, rollback), obs and
      telemetry (repro_torch.obs: spans, gauges, run_epochs_telemetry's
      device-side buffers).  This package imports neither.
"""

from repro_torch.engine.backends import (LEGACY_IMPLS, TileBackend,
                                         auto_kernel, get_backend,
                                         register_backend,
                                         registered_backends,
                                         resolve_backend,
                                         resolve_backend_for_layout)
from repro_torch.engine.data import (DSOState, GridData, TileData,
                                     as_tile_data, check_tile_stats,
                                     eta_schedule, gather_alpha, gather_w,
                                     init_state, init_state_data,
                                     make_grid_data,
                                     prob_meta, state_from_arrays,
                                     tile_data_from_arrays, tile_dims)
from repro_torch.engine.driver import (SolveResult, epoch_body,
                                       inner_iteration,
                                       resolve_backend_and_build, run_epoch,
                                       run_epochs, run_epochs_telemetry,
                                       solve, solve_serial,
                                       stage_block, staged_step,
                                       warn_ragged_eval)
from repro_torch.engine.evaluate import (make_csr_primal_eval,
                                         pd_gap_eval_hook, problem_eval_hook)
from repro_torch.engine.schedules import (SCHEDULES, Schedule, cyclic_perms,
                                          fixed_schedule, get_schedule,
                                          lpt_latin_square)
from repro_torch.engine.update import (block_tile_step, eq8_apply,
                                       sparse_tile_step)

__all__ = [
    "LEGACY_IMPLS", "TileBackend", "auto_kernel", "get_backend",
    "register_backend", "registered_backends", "resolve_backend",
    "resolve_backend_for_layout",
    "DSOState", "GridData", "TileData", "as_tile_data", "check_tile_stats",
    "eta_schedule", "gather_alpha", "gather_w", "init_state",
    "init_state_data",
    "make_grid_data", "prob_meta", "state_from_arrays",
    "tile_data_from_arrays", "tile_dims",
    "SolveResult", "epoch_body", "inner_iteration",
    "resolve_backend_and_build", "run_epoch", "run_epochs",
    "run_epochs_telemetry", "solve",
    "solve_serial", "stage_block", "staged_step", "warn_ragged_eval",
    "make_csr_primal_eval", "pd_gap_eval_hook", "problem_eval_hook",
    "SCHEDULES", "Schedule", "cyclic_perms", "fixed_schedule",
    "get_schedule", "lpt_latin_square",
    "block_tile_step", "eq8_apply", "sparse_tile_step",
]
