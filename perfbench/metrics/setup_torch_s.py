"""Set-up seconds in torch itself: ``import torch`` (on several cards the
launcher's and rank 0's), the card's first use (``cuda_init``), and where
the cell's set-up needs it torch's lazy ``import torch._dynamo``
(``import_dynamo``: the training kinds' optimizer)."""

PARTS = ("launcher_import_torch", "import_torch", "cuda_init", "import_dynamo")


def read(run):
    return run.setup_part_s(PARTS)
