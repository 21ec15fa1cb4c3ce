"""Traditional-ML substrate: training + interpreted inference.

This package is the analog of the paper's "ML runtime" (ONNX Runtime): trained
pipelines are DAGs of featurizers + tree/linear models, executed op-at-a-time
by :mod:`repro_torch.ml.pipeline`. Training is implemented natively (numpy CART /
GBDT / logistic regression) since no external ML library is assumed.
"""
from repro_torch.ml.trees import (
    DecisionTreeClassifier,
    GradientBoostingClassifier,
    RandomForestClassifier,
    TreeEnsemble,
)
from repro_torch.ml.linear import LinearRegression, LogisticRegression
from repro_torch.ml.featurizers import (
    LabelEncoder,
    Normalizer,
    OneHotEncoder,
    StandardScaler,
)
from repro_torch.ml.pipeline import (
    PipelineNode,
    TrainedPipeline,
    fit_pipeline,
    run_pipeline,
)

__all__ = [
    "DecisionTreeClassifier",
    "GradientBoostingClassifier",
    "RandomForestClassifier",
    "TreeEnsemble",
    "LinearRegression",
    "LogisticRegression",
    "LabelEncoder",
    "Normalizer",
    "OneHotEncoder",
    "StandardScaler",
    "PipelineNode",
    "TrainedPipeline",
    "fit_pipeline",
    "run_pipeline",
]
