from .ape_wrapper import APE
from .defaults import DefaultPredictor
