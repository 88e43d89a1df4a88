from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification, make_dataset,
)
from repro_torch.data.pipeline import (  # noqa: F401
    batch_iterator, slice_hw, vertical_partition,
)
