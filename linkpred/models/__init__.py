from linkpred.models.word2vec import train_sgns, SGNSConfig  # noqa: F401
from linkpred.models.logistic import fit_logistic, predict_proba  # noqa: F401
from linkpred.models import seal, twowl  # noqa: F401
