from repro_torch.data.datasets import (
    DATASETS,
    Dataset,
    make_credit_card,
    make_expedia,
    make_flights,
    make_hospital,
)
