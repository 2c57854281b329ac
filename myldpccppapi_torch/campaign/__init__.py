"""Resumable BER/FER waterfall campaigns (NumPy copy of the reference's
``myldpccppapi_tpu/campaign``)."""
from .waterfall import CampaignConfig, PointStats, WaterfallCampaign

__all__ = ["CampaignConfig", "PointStats", "WaterfallCampaign"]
