"""Deploy exports of the port: ONNX written without the `onnx` package
(`onnx_graph.export_onnx`, through `onnx_proto`)."""
