"""Legacy-style pipeline classes + one-call runners (reference old/ layer)."""

from .blocks import (Block, BlockGraph, FaceDetectBlock, FrameSourceBlock,
                     GatherBlock, HistogramBlock, OpticalFlowBlock,
                     ShotBoundariesBlock)
from .prelude import Pipeline
from .std import (BrightnessPipeline, ContrastPipeline, FaceDetectionPipeline,
                  FaceEmbeddingPipeline, FlowHistogramPipeline,
                  GenderDetectionPipeline, HistogramPipeline,
                  HSVHistogramPipeline, ObjectDetectionPipeline,
                  OpticalFlowPipeline, PoseDetectionPipeline,
                  SharpnessPipeline, ShotDetectionPipeline,
                  compute_brightness, compute_contrast, compute_flow,
                  compute_flow_histograms, compute_histograms,
                  compute_hsv_histograms, compute_sharpness, detect_faces,
                  detect_genders, detect_objects, detect_poses, detect_shots,
                  embed_faces)

__all__ = [n for n in dir() if not n.startswith("_")]
