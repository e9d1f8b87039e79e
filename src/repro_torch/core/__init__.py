from repro_torch.core.jobs import DEFAULT_TARGETS, LoRAJobSpec, tile_rows
from repro_torch.core.lora import (MultiLoRA, RankLayout, extract_adapter,
                                   merge_adapter_pair, pad_rank, proj,
                                   rank_axis_is_last, unpack_dense)
