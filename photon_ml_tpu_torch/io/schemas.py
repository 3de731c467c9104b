"""Avro schemas matching the reference's wire formats (the part of
photon_ml_tpu/io/schemas.py that training data, saved models and scores
use).

Field names/structure mirror photon-avro-schemas/src/main/avro/*.avsc so
data and models interchange byte-compatibly with the reference pipeline
and the JAX package (TrainingExampleAvro, FeatureAvro, NameTermValueAvro,
BayesianLinearModelAvro, ScoringResultAvro).
"""

NAME_TERM_VALUE = {
    "name": "NameTermValueAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

FEATURE = {
    "name": "FeatureAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE = {
    "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL = {
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

# reference model class names, for modelClass/lossFunction round-trips
SCORING_RESULT = {
    "name": "ScoringResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

MODEL_CLASS_BY_TASK = {
    "LOGISTIC_REGRESSION": "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    "LINEAR_REGRESSION": "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    "POISSON_REGRESSION": "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
TASK_BY_MODEL_CLASS = {v: k for k, v in MODEL_CLASS_BY_TASK.items()}
