from repro_torch.models import attention, convert, layers, model
