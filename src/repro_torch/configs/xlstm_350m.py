"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (7:1 ratio -> every 8th layer is
sLSTM). d_ff=0: xLSTM blocks have no separate MLP. [arXiv:2405.04517;
unverified] Runs long_500k (recurrent state decode)."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    ssm_chunk=128,
    rope_theta=0.0,
    long_context="run",
)
