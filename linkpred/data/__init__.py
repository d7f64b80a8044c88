from linkpred.data.graph import Graph  # noqa: F401
from linkpred.data import io, split  # noqa: F401
