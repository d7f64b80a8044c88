"""linkpred — a JAX graph link-prediction framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
repo NguyenTrieu903/Link-Prediction-GNN (see SURVEY.md): three link-prediction
model families (node2vec + logistic regression, SEAL enclosing-subgraph DGCNN,
TwoWL edge-level 2-WL GNN), a sparse graph substrate with segment/SpMM/SDDMM
kernels, an XLA-compiled biased random-walk engine with an SGNS (word2vec)
trainer, batched jit-able subgraph extraction with DRNL labeling, and
multi-device scaling via `jax.sharding` meshes.

Unlike the reference (networkx + TF1 + torch/PyG + Spark, all CPU), every
compute path here is built for an accelerator through XLA: static shapes,
padded sparse formats (ELL / capacity-padded COO), batched matmuls, and mesh
collectives.
"""

__version__ = "0.1.0"

from linkpred.data.graph import Graph  # noqa: F401
