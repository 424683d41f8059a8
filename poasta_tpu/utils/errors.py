"""Framework error types (reference: ``src/errors.rs``)."""


class PoastaError(Exception):
    """Base error for the POA framework."""


class InvalidAlignmentError(PoastaError):
    pass


class GraphError(PoastaError):
    pass
