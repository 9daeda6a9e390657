from .losses import AuralossLoss, L1Loss, MSELoss, MultiLoss, ValueLoss

__all__ = ["AuralossLoss", "L1Loss", "MSELoss", "MultiLoss", "ValueLoss"]
