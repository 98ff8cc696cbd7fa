"""Standard pipelines + one-call runners.

Reference parity: old/histograms.py (HistogramPipeline/HSVHistogram/
FlowHistogram), old/optical_flow.py (OpticalFlowPipeline/compute_flow),
old/imgproc.py pipelines (Brightness/Contrast/Sharpness), old/
pose_detection.py, plus runners for the newer per-module ops (shot
detection, face detection/embedding, object detection, gender).
"""

from __future__ import annotations

from .prelude import Pipeline


class HistogramPipeline(Pipeline):
    """compute_histograms(sc, videos=[...]) (old/histograms.py:6-18)."""

    job_suffix = "hist"

    def build_pipeline(self):
        return self._sc.ops.Histogram(frame=self._sources["frame"])


class HSVHistogramPipeline(Pipeline):
    """RGB→HSV then histogram (old/histograms.py:21-46)."""

    job_suffix = "hsv_hist"

    def build_pipeline(self):
        sc = self._sc
        hsv = sc.ops.ConvertToHSV(frame=self._sources["frame"])
        return sc.ops.Histogram(frame=hsv)


class OpticalFlowPipeline(Pipeline):
    """compute_flow (old/optical_flow.py:8-26)."""

    job_suffix = "flow"

    def build_pipeline(self):
        return self._sc.ops.OpticalFlow(frames=self._sources["frame"])


class FlowHistogramPipeline(Pipeline):
    """flow -> 64-bin magnitude/angle histograms (old/histograms.py:49-81)."""

    job_suffix = "flow_hist"

    def build_pipeline(self):
        sc = self._sc
        flow = sc.ops.OpticalFlow(frames=self._sources["frame"])
        return sc.ops.FlowHistogram(flow=flow)


class ShotDetectionPipeline(Pipeline):
    job_suffix = "shots"
    run_opts = {"work_packet_size": 128, "io_packet_size": 512}

    def build_pipeline(self):
        sc = self._sc
        hist = sc.ops.Histogram(frame=self._sources["frame"])
        return sc.ops.ShotBoundaries(histograms=hist)


class BrightnessPipeline(Pipeline):
    job_suffix = "brightness"

    def build_pipeline(self):
        return self._sc.ops.Brightness(frame=self._sources["frame"])


class ContrastPipeline(Pipeline):
    job_suffix = "contrast"

    def build_pipeline(self):
        return self._sc.ops.Contrast(frame=self._sources["frame"])


class SharpnessPipeline(Pipeline):
    job_suffix = "sharpness"

    def build_pipeline(self):
        return self._sc.ops.Sharpness(frame=self._sources["frame"])


class FaceDetectionPipeline(Pipeline):
    job_suffix = "faces"

    def build_pipeline(self):
        return self._sc.ops.MTCNNDetectFaces(frame=self._sources["frame"])


class FaceEmbeddingPipeline(Pipeline):
    """frame + bboxes -> FaceNet embeddings (needs `bboxes=` source)."""

    job_suffix = "face_embs"
    additional_sources = ["bboxes"]

    def build_pipeline(self):
        sc = self._sc
        bboxes = self._sources.get("bboxes")
        if bboxes is None:
            bboxes = sc.ops.MTCNNDetectFaces(frame=self._sources["frame"])
        return sc.ops.EmbedFaces(frame=self._sources["frame"], bboxes=bboxes)


class ObjectDetectionPipeline(Pipeline):
    job_suffix = "objects"

    def build_pipeline(self):
        return self._sc.ops.DetectObjects(frame=self._sources["frame"])


class GenderDetectionPipeline(Pipeline):
    job_suffix = "genders"

    def build_pipeline(self):
        sc = self._sc
        faces = sc.ops.MTCNNDetectFaces(frame=self._sources["frame"])
        return sc.ops.DetectGender(frame=self._sources["frame"], bboxes=faces)


class PoseDetectionPipeline(Pipeline):
    """old/pose_detection.py:7-62 (OpenPose body network)."""

    job_suffix = "poses"

    def build_pipeline(self):
        return self._sc.ops.OpenPose(frame=self._sources["frame"])


compute_histograms = HistogramPipeline.make_runner()
compute_hsv_histograms = HSVHistogramPipeline.make_runner()
compute_flow = OpticalFlowPipeline.make_runner()
compute_flow_histograms = FlowHistogramPipeline.make_runner()
detect_shots = ShotDetectionPipeline.make_runner()
compute_brightness = BrightnessPipeline.make_runner()
compute_contrast = ContrastPipeline.make_runner()
compute_sharpness = SharpnessPipeline.make_runner()
detect_faces = FaceDetectionPipeline.make_runner()
embed_faces = FaceEmbeddingPipeline.make_runner()
detect_objects = ObjectDetectionPipeline.make_runner()
detect_genders = GenderDetectionPipeline.make_runner()
detect_poses = PoseDetectionPipeline.make_runner()
