"""PyTorch/CUDA port of the monocular ORB-SLAM3 engine (`monoorbslam3_tpu`).

The JAX package stays the reference; this package mirrors its layout
(`utils/`, `models/`, `ops/`, `backend/`, `frontend/`, `sim.py`) so each
module's counterpart is found under the same name. It imports torch and
never jax.

Two slices are ported. The per-frame visual tracking path: ORB extraction
-> `finish_features` -> the coarse and local tracking stages (projection,
gated Hamming match, visual pose LM). The mapper's keyframe path: the
triangulation and fuse searches (`frontend/local_mapping.py`) and the
window bundle adjustment `backend/solver.schur_ba`.

Four functions run hand kernels on a CUDA tensor (`csrc/`): the atlas
patch gather (`ops/pallas_kernels.gather_patches_dyn`), the gated top-2
match (`ops/match_pallas._match_rows`), the Hamming block
(`ops/pallas_kernels.hamming_matrix_pallas`) and the SPD Cholesky solve
(`ops/chol_pallas.chol_solve`). A CPU tensor takes their plain PyTorch
versions.
"""

from .utils.precision import f32_matmuls

f32_matmuls()
