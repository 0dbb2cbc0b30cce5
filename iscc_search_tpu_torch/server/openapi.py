"""
OpenAPI 3.1 spec of the REST surface (copy of
``iscc_search_tpu/server/openapi.py``).

The JAX package derives the component schemas from its pydantic wire models
with ``pydantic.json_schema.models_json_schema``; the port has no pydantic,
so it serves the schemas that call produced, kept beside this module in
``openapi_schemas.json``. ``tests/test_torch_server.py`` holds
``build_openapi()`` equal to the JAX package's, so a change to the JAX
schemas fails a test until the file is written again.
"""

from __future__ import annotations

import json
from pathlib import Path

from iscc_search_tpu_torch import __version__

SCHEMAS_FILE = Path(__file__).parent / "openapi_schemas.json"


def _ref(name):
    # type: (str) -> dict
    return {"$ref": f"#/components/schemas/{name}"}


def _json_content(schema):
    # type: (dict) -> dict
    return {"application/json": {"schema": schema}}


def build_openapi():
    # type: () -> dict
    """Build the OpenAPI 3.1 document for the REST surface."""
    schemas = json.loads(SCHEMAS_FILE.read_text())

    err = {"description": "Error", "content": _json_content(_ref("HttpError"))}
    name_param = {
        "name": "name",
        "in": "path",
        "required": True,
        "schema": {"type": "string", "pattern": "^[a-z][a-z0-9]*$"},
    }
    limit_param = {
        "name": "limit",
        "in": "query",
        "required": False,
        "schema": {"type": "integer", "default": 100, "minimum": 1},
    }

    paths = {
        "/indexes": {
            "get": {
                "operationId": "list_indexes",
                "tags": ["indexes"],
                "responses": {
                    "200": {
                        "description": "Indexes",
                        "content": _json_content({"type": "array", "items": _ref("IsccIndex")}),
                    }
                },
            },
            "post": {
                "operationId": "create_index",
                "tags": ["indexes"],
                "requestBody": {"required": True, "content": _json_content(_ref("IsccIndex"))},
                "responses": {
                    "201": {"description": "Created", "content": _json_content(_ref("IsccIndex"))},
                    "409": err,
                    "400": err,
                },
            },
        },
        "/indexes/{name}": {
            "get": {
                "operationId": "get_index",
                "tags": ["indexes"],
                "parameters": [name_param],
                "responses": {
                    "200": {"description": "Index metadata", "content": _json_content(_ref("IsccIndex"))},
                    "404": err,
                },
            },
            "delete": {
                "operationId": "delete_index",
                "tags": ["indexes"],
                "parameters": [name_param],
                "responses": {"204": {"description": "Deleted"}, "404": err},
            },
        },
        "/indexes/{name}/assets": {
            "post": {
                "operationId": "add_assets",
                "tags": ["assets"],
                "parameters": [name_param],
                "requestBody": {
                    "required": True,
                    "content": _json_content({"type": "array", "items": _ref("IsccEntry")}),
                },
                "responses": {
                    "201": {
                        "description": "Add results",
                        "content": _json_content({"type": "array", "items": _ref("IsccAddResult")}),
                    },
                    "404": err,
                    "400": err,
                },
            }
        },
        "/indexes/{name}/assets/{iscc_id}": {
            "get": {
                "operationId": "get_asset",
                "tags": ["assets"],
                "parameters": [
                    name_param,
                    {"name": "iscc_id", "in": "path", "required": True, "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {"description": "Asset", "content": _json_content(_ref("IsccEntry"))},
                    "404": err,
                    "400": err,
                },
            }
        },
        "/indexes/{name}/search": {
            "post": {
                "operationId": "search_post",
                "tags": ["search"],
                "parameters": [name_param, limit_param],
                "requestBody": {"required": True, "content": _json_content(_ref("IsccQuery"))},
                "responses": {
                    "200": {"description": "Search result", "content": _json_content(_ref("IsccSearchResult"))},
                    "404": err,
                    "400": err,
                },
            },
            "get": {
                "operationId": "search_get",
                "tags": ["search"],
                "parameters": [
                    name_param,
                    limit_param,
                    {"name": "iscc_code", "in": "query", "required": True, "schema": {"type": "string"}},
                ],
                "responses": {
                    "200": {"description": "Search result", "content": _json_content(_ref("IsccSearchResult"))},
                    "404": err,
                    "400": err,
                },
            },
        },
    }

    # Document auth and validation responses on every operation: without a
    # `security` requirement referencing the scheme, generated clients and
    # the /docs Try-It UI would never send X-API-Key and every call would
    # 401 on a secured deployment.
    for path_item in paths.values():
        for op in path_item.values():
            op["security"] = [{"ApiKeyAuth": []}, {}]  # optional: public mode has no secret
            op["responses"].setdefault("401", {"description": "Missing or invalid API key"})
            op["responses"].setdefault(
                "422", {"description": "Validation error", "content": _json_content(_ref("HttpError"))}
            )

    return {
        "openapi": "3.1.0",
        "info": {
            "title": "ISCC-Search TPU API",
            "description": "TPU-native nearest-neighbor multi-index for the "
            "International Standard Content Code (ISCC)",
            "version": __version__,
        },
        "paths": paths,
        "components": {
            "schemas": schemas,
            "securitySchemes": {
                "ApiKeyAuth": {"type": "apiKey", "in": "header", "name": "X-API-Key"}
            },
        },
    }
