"""The port's data layer: charset, featurization, the synthetic and file
corpora, property targets and the batch pipeline (the reference's
``molvax.data`` exports, numpy on the host and torch on the device)."""

from .charset import Charset, DEFAULT_CHARSET, PAD_CHAR
from .featurize import (
    argmax_codes,
    decode_codes,
    encode_smiles,
    is_valid_smiles,
    one_hot,
    one_hot_to_smiles,
    smiles_to_one_hot,
    valid_fraction,
)
from .pipeline import BatchIterator
from .properties import computed_properties, descriptors, properties_of
from .smiles_check import chem_valid, chem_valid_fraction, parse_graph, parse_smiles
from .zinc import (
    Dataset,
    export_h5,
    load_dataset,
    load_h5,
    load_smiles_file,
    property_targets,
    surrogate_properties,
    synthetic_dataset,
    synthetic_smiles,
)

__all__ = [
    "Charset",
    "DEFAULT_CHARSET",
    "PAD_CHAR",
    "argmax_codes",
    "decode_codes",
    "encode_smiles",
    "is_valid_smiles",
    "one_hot",
    "one_hot_to_smiles",
    "smiles_to_one_hot",
    "valid_fraction",
    "chem_valid",
    "chem_valid_fraction",
    "computed_properties",
    "descriptors",
    "parse_graph",
    "parse_smiles",
    "properties_of",
    "property_targets",
    "BatchIterator",
    "Dataset",
    "export_h5",
    "load_dataset",
    "load_h5",
    "load_smiles_file",
    "surrogate_properties",
    "synthetic_dataset",
    "synthetic_smiles",
]
