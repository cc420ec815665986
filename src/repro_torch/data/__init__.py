from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                       frontend_stub_embeds)

__all__ = ["DataConfig", "SyntheticTokens", "frontend_stub_embeds"]
