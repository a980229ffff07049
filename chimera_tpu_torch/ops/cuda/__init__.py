"""Hand-written CUDA kernels for Hopper: ``build`` compiles and loads
``chimera_tpu_torch/csrc/*.cu``; each kernel module holds its wrapper (with
a launch counter) and the plain PyTorch version of the same function."""


def launch_counters() -> dict:
    """Every kernel's launch counter: {kernel id: (wrapper, attribute)}; K3
    is named by the forward mode it differentiates (K3 after K1a, K3b after
    K1b, K3c after K1c, K3d after K1d), K4b is K4's adjoint, K5 the 3-D
    lattice KDE of kind 'full'."""
    from chimera_tpu_torch.ops.cuda import fused, kde, kde3d, rows

    adjoint = fused.fused_weights_kde_adjoint
    return {"K1a": (fused.fused_weights_kde, "launches"),
            "K1b": (fused.fused_weights_kde, "launches_b"),
            "K1c": (fused.fused_row_stats, "launches"),
            "K1d": (fused.fused_weights_kde, "launches_d"),
            "K1e": (fused.fused_weights_kde, "launches_e"),
            "K2": (rows.fused_rows_contract, "launches"),
            "K2b": (rows.fused_rows_contract_adjoint, "launches"),
            "K3": (adjoint, "launches"), "K3b": (adjoint, "launches_b"),
            "K3c": (adjoint, "launches_c"), "K3d": (adjoint, "launches_d"),
            "K4": (kde.kde1d_grid, "launches"),
            "K4b": (kde.kde1d_grid_adjoint, "launches"),
            "K5": (kde3d.lattice_kde3d, "launches"),
            "K5b": (kde3d.lattice_kde3d_adjoint, "launches")}


def launch_counts() -> dict:
    """{kernel id: launches so far} of every kernel."""
    return {k: getattr(w, a) for k, (w, a) in launch_counters().items()}
