from linkpred.ops.segment import segment_sum, degree_from_edges  # noqa: F401
from linkpred.ops.spmm import spmm_coo, spmm_ell, gcn_aggregate  # noqa: F401
from linkpred.ops.sddmm import sddmm_coo  # noqa: F401
