from .params import CaseParams, Datasets, Params, convert_value
from .schema import DER_TAGS, SCHEMA, SINGLE_INSTANCE_TAGS

__all__ = ["CaseParams", "Datasets", "Params", "convert_value",
           "DER_TAGS", "SCHEMA", "SINGLE_INSTANCE_TAGS"]
