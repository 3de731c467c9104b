"""Avro schemas matching the reference's wire formats (the part of
photon_ml_tpu/io/schemas.py that training data, saved models, scores and
the diagnostic reports use).

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

LATENT_FACTOR = {
    "name": "LatentFactorAvro",
    "namespace": "com.linkedin.photon.ml.avro.generated",
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
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


# ---------------------------------------------------------------------------
# diagnostic / evaluation report schemas
# (photon-avro-schemas/src/main/avro/{Point2DAvro, Curve2DAvro,
#  SegmentContextAvro, TrainingTaskAvro, MLPackageAvro,
#  ConvergenceReasonAvro, TrainingContextAvro, EvaluationContextAvro,
#  EvaluationResultAvro, FeatureSummarizationResultAvro}.avsc —
# field names/order/types byte-compatible)
# ---------------------------------------------------------------------------

_NS = "com.linkedin.photon.avro.generated"

POINT_2D = {
    "name": "Point2DAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "x", "type": "double"},
        {"name": "y", "type": "double"},
    ],
}

CURVE_2D = {
    "name": "Curve2DAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "xLabel", "type": "string"},
        {"name": "yLabel", "type": "string"},
        {"name": "points", "type": {"type": "array", "items": POINT_2D}},
    ],
}

SEGMENT_CONTEXT = {
    "name": "SegmentContextAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "value", "type": "string"},
    ],
}

TRAINING_TASK = {
    "name": "TrainingTaskAvro",
    "namespace": _NS,
    "type": "enum",
    "symbols": ["LINEAR_REGRESSION", "LOGISTIC_REGRESSION", "POISSON_REGRESSION"],
}

ML_PACKAGE = {
    "name": "MLPackageAvro",
    "namespace": _NS,
    "type": "enum",
    "symbols": ["R", "LIBLINEAR", "ADMM", "PHOTONML"],
}

CONVERGENCE_REASON = {
    "name": "ConvergenceReasonAvro",
    "namespace": _NS,
    "type": "enum",
    "symbols": [
        "MAX_ITERATIONS",
        "FUNCTION_VALUES_CONVERGED",
        "GRADIENT_CONVERGED",
        "SEARCH_FAILED",
        "OBJECTIVE_NOT_IMPROVING",
    ],
}

TRAINING_CONTEXT = {
    "name": "TrainingContextAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "trainingTask", "type": TRAINING_TASK},
        {"name": "lambda1", "type": "double"},
        {"name": "lambda2", "type": "double"},
        {"name": "applyFeatureNormalization", "type": "boolean"},
        {"name": "timestamp", "type": "string"},
        {"name": "modelSource", "type": ML_PACKAGE},
        {"name": "optimizer", "type": ["null", "string"]},
        {"name": "convergenceTolerance", "type": "double"},
        {"name": "numberOfIterations", "type": "int"},
        {"name": "convergenceReason", "type": ["null", CONVERGENCE_REASON]},
        {"name": "sourceDataPath", "type": "string"},
        {"name": "description", "type": ["null", "string"]},
        {"name": "lossFunction", "type": "string"},
        {"name": "scoreFunction", "type": "string"},
    ],
}

EVALUATION_CONTEXT = {
    "name": "EvaluationContextAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "metricsCalculator", "type": "string"},
        {"name": "modelId", "type": "string"},
        {"name": "modelPath", "type": "string"},
        {"name": "modelTrainingContext", "type": TRAINING_CONTEXT},
        {"name": "timestamp", "type": "string"},
        {"name": "dataPath", "type": "string"},
        {"name": "segmentContext", "type": ["null", SEGMENT_CONTEXT], "default": None},
    ],
}

EVALUATION_RESULT = {
    "name": "EvaluationResultAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "evaluationContext", "type": EVALUATION_CONTEXT},
        {"name": "scalarMetrics", "type": {"type": "map", "values": "double"}},
        {"name": "curves", "type": {"type": "map", "values": CURVE_2D}},
    ],
}

FEATURE_SUMMARIZATION_RESULT = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": _NS,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}

# reference loss-function class names (TrainingContextAvro.lossFunction)
LOSS_CLASS_BY_TASK = {
    "LOGISTIC_REGRESSION": "com.linkedin.photon.ml.function.LogisticLossFunction",
    "LINEAR_REGRESSION": "com.linkedin.photon.ml.function.SquaredLossFunction",
    "POISSON_REGRESSION": "com.linkedin.photon.ml.function.PoissonLossFunction",
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": "com.linkedin.photon.ml.function.SmoothedHingeLossFunction",
}
