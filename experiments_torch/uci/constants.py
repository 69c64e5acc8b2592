"""UCI dataset column schemas (counterpart of ``experiments/uci/constants.py``,
kept as the port's own copy).

CSV files are read from a datasets directory as ``<name>.csv`` with these
columns, matched case- and space-insensitively by the mains. The CSVs are
not shipped; ``make_synthetic_datasets.py`` writes schema-compatible
synthetic stand-ins.
"""

from __future__ import annotations

import enum
from abc import ABC
from dataclasses import dataclass


@dataclass
class Dataset(ABC):
    input_column_names: list[str]
    output_column_name: str


# --- regression -------------------------------------------------------------
class BostonDataset(Dataset):
    # https://archive.ics.uci.edu/dataset (boston housing)
    input_column_names = [
        "crim", "zn", "indus", "chas", "nox", "rm", "age", "dis", "rad",
        "tax", "ptratio", "b", "lstat",
    ]
    output_column_name = "medv"


class ConcreteDataset(Dataset):
    input_column_names = [
        "cement", "blast_furnace_slag", "fly_ash", "water", "superplasticizer",
        "coarse_aggregate", "fine_aggregate", "age",
    ]
    output_column_name = "concrete_compressive_strength"


class EnergyCoolingDataset(Dataset):
    input_column_names = ["X1", "X2", "X3", "X4", "X5", "X6", "X7", "X8"]
    output_column_name = "Y2"


class EnergyHeatingDataset(Dataset):
    input_column_names = ["X1", "X2", "X3", "X4", "X5", "X6", "X7", "X8"]
    output_column_name = "Y1"


class Kin8nmDataset(Dataset):
    input_column_names = [
        "theta1", "theta2", "theta3", "theta4", "theta5", "theta6", "theta7",
        "theta8",
    ]
    output_column_name = "y"


class WineQualityDataset(Dataset):
    input_column_names = [
        "fixed acidity", "volatile acidity", "citric acid", "residual sugar",
        "chlorides", "free sulfur dioxide", "total sulfur dioxide", "density",
        "pH", "sulphates", "alcohol",
    ]
    output_column_name = "quality"


# --- binary classification ---------------------------------------------------
class BreastDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/15/breast+cancer+wisconsin+original
    input_column_names = [
        "clump_thickness", "size_uniformity", "shape_uniformity",
        "marginal_adhesion", "epithelial_size", "bare_nucleoli",
        "bland_chromatin", "normal_nucleoli", "mitoses",
    ]
    output_column_name = "class"


class DiabetesDataset(Dataset):
    input_column_names = [
        "Pregnancies", "Glucose", "BloodPressure", "SkinThickness", "Insulin",
        "BMI", "DiabetesPedigreeFunction", "Age",
    ]
    output_column_name = "Outcome"


class HeartDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/45/heart+disease
    input_column_names = [
        "age", "sex", "cp", "trestbps", "chol", "fbs", "restecg", "thalach",
        "exang", "oldpeak", "slope", "ca", "thal",
    ]
    output_column_name = "target"


class IonosphereDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/52/ionosphere
    input_column_names = [f"column_{c}" for c in "abcdefghijklmnopqrstuvwxyz"] + [
        "column_aa", "column_ab", "column_ac", "column_ad", "column_ae",
        "column_af", "column_ag", "column_ah",
    ]
    output_column_name = "column_ai"


class MushroomsDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/373/drug+consumption+quantified
    input_column_names = [
        "age", "gender", "education", "country", "ethnicity", "nscore",
        "escore", "oscore", "ascore", "cscore", "impulsive", "ss",
    ]
    output_column_name = "mushrooms"


class RiceDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/545/rice+cammeo+and+osmancik
    input_column_names = [
        "Area", "Perimeter", "Major_Axis_Length", "Minor_Axis_Length",
        "Eccentricity", "Convex_Area", "Extent",
    ]
    output_column_name = "Class"


class WineColourDataset(Dataset):
    input_column_names = [
        "fixed acidity", "volatile acidity", "citric acid", "residual sugar",
        "chlorides", "free sulfur dioxide", "total sulfur dioxide", "density",
        "pH", "sulphates", "alcohol",
    ]
    output_column_name = "colour"


class YeastDataset(Dataset):
    # https://archive.ics.uci.edu/dataset/110/yeast — CYT/NUC binary subset
    input_column_names = ["mcg", "gvh", "alm", "mit", "erl", "pox", "vac", "nuc"]
    output_column_name = "class"


class RegressionDatasetSchema(str, enum.Enum):
    boston = "boston"
    concrete = "concrete"
    energy_cooling = "energy_cooling"
    energy_heating = "energy_heating"
    kin8nm = "kin8nm"
    wine_quality = "wine_quality"


class ClassificationDatasetSchema(str, enum.Enum):
    breast = "breast"
    diabetes = "diabetes"
    heart = "heart"
    ionosphere = "ionosphere"
    mushrooms = "mushrooms"
    rice = "rice"
    wine_colour = "wine_colour"
    yeast = "yeast"


DATASET_SCHEMA_MAPPING = {
    RegressionDatasetSchema.boston: BostonDataset,
    RegressionDatasetSchema.concrete: ConcreteDataset,
    RegressionDatasetSchema.energy_cooling: EnergyCoolingDataset,
    RegressionDatasetSchema.energy_heating: EnergyHeatingDataset,
    RegressionDatasetSchema.kin8nm: Kin8nmDataset,
    RegressionDatasetSchema.wine_quality: WineQualityDataset,
    ClassificationDatasetSchema.breast: BreastDataset,
    ClassificationDatasetSchema.diabetes: DiabetesDataset,
    ClassificationDatasetSchema.heart: HeartDataset,
    ClassificationDatasetSchema.ionosphere: IonosphereDataset,
    ClassificationDatasetSchema.mushrooms: MushroomsDataset,
    ClassificationDatasetSchema.rice: RiceDataset,
    ClassificationDatasetSchema.wine_colour: WineColourDataset,
    ClassificationDatasetSchema.yeast: YeastDataset,
}


# --- extra REAL datasets available offline (sklearn-bundled UCI data) --------
# Not part of the reference's dataset list; registered separately so the
# full-suite loops stay reference-identical while ``--dataset breast_wdbc``
# etc. run on genuinely real data in network-restricted environments
# (see fetch_datasets.py --sklearn-bundled).
class BreastWDBCDataset(Dataset):
    # UCI Breast Cancer Wisconsin DIAGNOSTIC, bundled with scikit-learn
    _FEATS = (
        "radius", "texture", "perimeter", "area", "smoothness",
        "compactness", "concavity", "concave_points", "symmetry",
        "fractal_dimension",
    )
    input_column_names = (
        [f"mean_{f}" for f in _FEATS]
        + [f"{f}_error" for f in _FEATS]
        + [f"worst_{f}" for f in _FEATS]
    )
    output_column_name = "target"


class DiabetesSklearnDataset(Dataset):
    # the real diabetes progression study (Efron et al.), bundled with sklearn
    input_column_names = ["age", "sex", "bmi", "bp", "s1", "s2", "s3", "s4", "s5", "s6"]
    output_column_name = "target"


class DigitsEvenDataset(Dataset):
    # real UCI optical digits (1797 x 64, bundled with sklearn), binarised
    # even-vs-odd so every sample is kept
    input_column_names = [f"px{i}" for i in range(64)]
    output_column_name = "target"


class IrisBinaryDataset(Dataset):
    # real UCI iris (bundled with sklearn), restricted to the classic
    # non-separable pair versicolor-vs-virginica (100 x 4; setosa is
    # linearly separable from both and is dropped)
    input_column_names = [
        "sepal_length_cm", "sepal_width_cm", "petal_length_cm", "petal_width_cm",
    ]
    output_column_name = "target"


class WineUCIDataset(Dataset):
    # real UCI wine (178 x 13, bundled with sklearn), cultivar-1-vs-rest
    input_column_names = [
        "alcohol", "malic_acid", "ash", "alcalinity_of_ash", "magnesium",
        "total_phenols", "flavanoids", "nonflavanoid_phenols",
        "proanthocyanins", "color_intensity", "hue",
        "od280_od315_of_diluted_wines", "proline",
    ]
    output_column_name = "target"


class WineAlcoholDataset(Dataset):
    # real UCI wine chemical analysis (178 x 13, bundled with sklearn) as a
    # REGRESSION task: predict the measured alcohol content (% vol) from the
    # other 12 chemical measurements (cultivar label dropped)
    input_column_names = [
        "malic_acid", "ash", "alcalinity_of_ash", "magnesium",
        "total_phenols", "flavanoids", "nonflavanoid_phenols",
        "proanthocyanins", "color_intensity", "hue",
        "od280_od315_of_diluted_wines", "proline",
    ]
    output_column_name = "alcohol"


class IrisPetalDataset(Dataset):
    # real UCI iris (150 x 4, bundled with sklearn) as a REGRESSION task:
    # predict the measured petal length (cm) from the other three flower
    # measurements (species label dropped) — Anderson's original data
    input_column_names = ["sepal_length_cm", "sepal_width_cm", "petal_width_cm"]
    output_column_name = "petal_length_cm"


EXTRA_REGRESSION_DATASETS = {
    "diabetes_sklearn": DiabetesSklearnDataset,
    "wine_alcohol": WineAlcoholDataset,
    "iris_petal": IrisPetalDataset,
}
EXTRA_CLASSIFICATION_DATASETS = {
    "breast_wdbc": BreastWDBCDataset,
    "digits_even": DigitsEvenDataset,
    "iris_binary": IrisBinaryDataset,
    "wine_uci": WineUCIDataset,
}


def resolve_schema(name: str) -> Dataset:
    """Schema lookup by dataset name: the reference's 6+8 datasets first,
    then the extra offline real datasets."""
    for enum_cls in (RegressionDatasetSchema, ClassificationDatasetSchema):
        try:
            return DATASET_SCHEMA_MAPPING[enum_cls(name)]
        except ValueError:
            continue
    for extra in (EXTRA_REGRESSION_DATASETS, EXTRA_CLASSIFICATION_DATASETS):
        if name in extra:
            return extra[name]
    raise KeyError(f"unknown dataset {name!r}")
