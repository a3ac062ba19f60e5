from repro_torch.data.synthetic import (SyntheticDataset,  # noqa: F401
                                        dataset_for, make_batch)
