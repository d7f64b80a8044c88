from linkpred.utils import metrics, records, timer  # noqa: F401
