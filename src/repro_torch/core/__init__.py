"""Simulator core: consistency models, delivery model, the ESSPTable
simulator and its staleness readout."""
