"""xlstm-125m [ssm] — 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304,
alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own internal up/down projections
(mLSTM pre-up-projection, sLSTM post-FFN with factor 4/3); there is no
separate transformer MLP. Scan 6 superblocks of (mLSTM, sLSTM) = 12L.
"""

from repro_torch.config import MLSTM, SLSTM, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    citation="arXiv:2405.04517",
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    superblock=(MLSTM, SLSTM),
    n_superblocks=6,
    xlstm=XLSTMConfig(expand=2, conv_width=4),
    max_context=2048,
)
