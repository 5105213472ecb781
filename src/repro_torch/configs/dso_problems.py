"""The paper's own experiment configurations (Sec. 5 / App. C).

CPU-scale stand-ins for the public datasets of Table 2, with the paper's
regularization-parameter sweep {1e-3, 1e-4, 1e-5, 1e-6}."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DSOProblemConfig:
    dataset: str          # key into repro_torch.data.synthetic.PAPER_LIKE
    loss: str             # hinge | logistic | square
    lam: float
    epochs: int = 40
    eta0: float = 0.5
    p: int = 4            # processors
    alpha0: float = 0.0   # App. B: 0.0005 for logistic


LAMBDAS = [1e-3, 1e-4, 1e-5, 1e-6]

SVM_REALSIM = DSOProblemConfig("real-sim", "hinge", 1e-4)
SVM_KDDA = DSOProblemConfig("kdda", "hinge", 1e-4)
SVM_OCR = DSOProblemConfig("ocr", "hinge", 1e-4)
LOGISTIC_REALSIM = DSOProblemConfig("real-sim", "logistic", 1e-4,
                                    alpha0=0.0005)
LOGISTIC_NEWS20 = DSOProblemConfig("news20", "logistic", 1e-4, alpha0=0.0005)

ALL = {
    "svm-real-sim": SVM_REALSIM,
    "svm-kdda": SVM_KDDA,
    "svm-ocr": SVM_OCR,
    "logistic-real-sim": LOGISTIC_REALSIM,
    "logistic-news20": LOGISTIC_NEWS20,
}
