from linkpred.pipelines.logistic_pipeline import run_logistic  # noqa: F401
from linkpred.pipelines.seal_pipeline import run_seal  # noqa: F401
from linkpred.pipelines.twowl_pipeline import run_twowl  # noqa: F401
