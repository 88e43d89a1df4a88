from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification, lm_batch_iterator, make_dataset,
)
from repro_torch.data.pipeline import (  # noqa: F401
    Prefetcher, batch_iterator, slice_hw, vertical_partition,
)
