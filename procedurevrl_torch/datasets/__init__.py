"""The host data pipeline: datasets, decoder, transforms, tokenizer, the
native preprocess and the threaded loader with its copy to the card."""

from procedurevrl_torch.datasets.build import DATASET_REGISTRY, build_dataset  # noqa: F401
import procedurevrl_torch.datasets.howto100m  # noqa: F401,E402 (registers)
import procedurevrl_torch.datasets.epickitchens  # noqa: F401,E402 (registers)
